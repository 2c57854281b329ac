"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

For cell ``<config>.<traffic>`` the harness reads:

* ``BENCHMARK.json``: the cell's configuration, traffic, chips and the
  metrics it reports;
* ``portbench/configs/<config>.json``: the code, its table file (beside
  it, checked against its SHA-256), the decoder settings and semantics;
* ``portbench/traffic/<traffic>.json``: the parameters of the traffic mix,
  and the driver (``portbench/drivers/<driver>.py``) that generates it;
* ``portbench/workloads/<cell>.json``: what the cell expects of the
  program (its implementation, launch counter and kernel);
* ``portbench/metrics/<metric>.py``: one reader per per-layer metric.

A new cell, configuration, traffic mix or metric is new files and entries;
no file here changes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import pathlib
from typing import List

__all__ = ["Cell", "ROOT", "load_benchmark", "load_cell", "metric_reader"]

#: the checkout's root: BENCHMARK.json and portbench/ are here
ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    here: pathlib.Path = HERE

    def table_text(self) -> str:
        """The configuration's table file, checked against its SHA-256."""
        data = (self.here / "configs" / self.config["table"]).read_bytes()
        got = hashlib.sha256(data).hexdigest()
        if got != self.config["table_sha256"]:
            raise ValueError(f"{self.config['table']}: SHA-256 {got} is not the "
                             f"configuration's {self.config['table_sha256']}")
        return data.decode()

    def reference_family(self):
        """``portbench.reference.<family>``: the table's reading, the code
        and its encoder, with nothing of the program."""
        return importlib.import_module(f"portbench.reference.{self.config['family']}")

    def program_family(self):
        """``portbench.families.<family>``: the program's code from the
        same table."""
        return importlib.import_module(f"portbench.families.{self.config['family']}")

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.traffic['driver']}")


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    here = root / "portbench"
    return Cell(
        name=name, chips=w["chips"],
        config=_json(here / "configs" / f"{w['config']}.json"),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        workload=_json(here / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, name)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, name)],
        here=here)


def metric_reader(name: str, here: pathlib.Path = HERE):
    """The reader of per-layer metric ``name``: ``portbench/metrics/<name>.py``
    (loaded by path: a metric's name may hold dots), whose ``read(ctx)``
    returns the value, or None where it finds nothing to read."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
