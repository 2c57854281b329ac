"""Import isolation, by whole top-level module names: nothing a run
imports is ``jax``, ``jaxlib``, ``flax`` or ``myldpccppapi_tpu``, and the
reference imports nothing whose top-level name is ``myldpccppapi_torch``."""
import ast
import json
import subprocess
import sys

from portbench.run import FORBIDDEN
from portbench.spec import HERE, ROOT

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench.run import run_cell
from portbench.tests.cells import tiny
run_cell(tiny(), 5, 0.2, {trace}, time.time(), device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from portbench.reference import dvbs2, qc
cfg = {{"name": "x", "n": 16200, "k": 7200}}
code = dvbs2.build(cfg, dvbs2.parse(open({table!r}).read()))
u = torch.zeros((2, code.k), dtype=torch.uint8)
qc.decode(code, 1.0 - 2.0 * dvbs2.encode(code, u).float(), 0.8, 0.0, 5)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

def _modules(src: str) -> set:
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_holds_no_jax():
    for trace in (False, True):
        held = _modules(RUN.format(root=str(ROOT), trace=trace))
        assert "myldpccppapi_torch" in held  # the program ran
        assert not held & set(FORBIDDEN)


def test_the_reference_holds_nothing_of_the_program():
    table = str(HERE / "tests" / "dvbs2_16200_r12.table.txt")
    held = _modules(REFERENCE.format(root=str(ROOT), table=table))
    assert "myldpccppapi_torch" not in held
    assert not held & set(FORBIDDEN)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_sources_name_no_forbidden_module():
    for path in HERE.rglob("*.py"):
        names = set(_imports(path))
        assert not names & set(FORBIDDEN), path
        if "reference" in path.relative_to(HERE).parts:
            assert "myldpccppapi_torch" not in names, path


def test_forbidden_modules_compares_whole_top_level_names():
    import sys
    import types

    from portbench.run import forbidden_modules

    assert forbidden_modules() == []
    sys.modules["jaxlike_pkg"] = types.ModuleType("jaxlike_pkg")  # not "jax"
    sys.modules["myldpccppapi_tpu_x"] = types.ModuleType("myldpccppapi_tpu_x")
    try:
        assert forbidden_modules() == []
        sys.modules["jax"] = types.ModuleType("jax")
        assert forbidden_modules() == ["jax"]
    finally:
        for m in ("jaxlike_pkg", "myldpccppapi_tpu_x", "jax"):
            sys.modules.pop(m, None)
