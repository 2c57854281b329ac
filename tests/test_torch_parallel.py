"""The port's multi-process campaign (myldpccppapi_torch/parallel/) on the
CPU with gloo: the sharded step on 1, 2 and 4 spawned ranks against a
one-process recount of ``sim_step`` per (mesh position, point), and against
the JAX package's ``make_sharded_campaign_step`` on the 8-device virtual
CPU mesh of tests/conftest.py (layout, refusals, the statistics at 30 dB and
-10 dB, and the FER at a middle SNR within a binomial bound: the noise
streams differ by design).  Every rank runs on one thread
(``OMP_NUM_THREADS=1``, which torch reads at start as
``set_num_threads(1)``)."""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myldpccppapi_tpu import DecoderConfig as RefDecoderConfig
from myldpccppapi_tpu import cli as ref_cli
from myldpccppapi_tpu.codes import wimax as ref_wimax
from myldpccppapi_tpu.parallel import make_mesh as ref_make_mesh
from myldpccppapi_tpu.parallel import make_sharded_campaign_step as ref_step

from myldpccppapi_torch import DecoderConfig, cli, wimax
from myldpccppapi_torch.campaign import CampaignConfig, WaterfallCampaign
from myldpccppapi_torch.ops.modulation import make_modulation
from myldpccppapi_torch.parallel import (
    Mesh,
    SimStats,
    init_from_env,
    make_mesh,
    make_sharded_campaign_step,
    point_generator,
    sim_step,
    spawn,
)
from myldpccppapi_torch.parallel import dist as pdist
from myldpccppapi_torch.parallel.dryrun import multichip_mesh, run_step, step_rank
from myldpccppapi_torch.sim import make_decode_fn, matmul_encode_fn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = wimax(576, "1/2")
CFG = DecoderConfig(max_iters=8)
CRC_CFG = DecoderConfig(max_iters=8, crc="16")
BCH = ("bch", 16, 12)
SNR_DATA = ((2, 2), ("snr", "data"))
#: the JAX comparison: 30 dB (no errors), -10 dB (every frame runs all
#: MAX_ITERS sweeps unconverged), and a middle SNR twice (FER ~0.57)
MID_SNR = 1.5
JAX_SNRS = [30.0, -10.0, MID_SNR, MID_SNR]
JAX_FRAMES = 2048  # per point: 512 x 4 data devices, 1024 x 2 data ranks


def case(mesh, snrs, bpd=4, cfg=CFG, seed=5, **kw):
    shape, axes = mesh
    return dict(code=CODE, cfg=cfg, mesh_shape=shape, axis_names=axes, seed=seed,
                snr_db=snrs, batch_per_device=bpd, **kw)


#: the cases spawned at 4, 2 and 1 ranks, by name
CASES4 = {
    "crc16_2d": case(SNR_DATA, [1.0, 2.0, 3.0, 1.5], cfg=CRC_CFG, snr_axis="snr"),
    "bch_2d": case(SNR_DATA, [2.0, 3.0, 1.5, 2.5], outer=BCH, snr_axis="snr"),
    "16apsk_2d": case(SNR_DATA, [11.0, 12.0, 11.5, 12.5], snr_axis="snr",
                      mod=make_modulation("16apsk")),
    "data_1d": case(((4,), ("data",)), [1.0]),
    # config 5's ("host", "data") mesh without an snr axis: one copy
    "host_data": case(((2, 2), ("host", "data")), [1.0, 2.0]),
    # a mesh smaller than the world: ranks 2 and 3 fill nothing
    "smaller_mesh": case(((2,), ("data",)), [1.5, 2.0]),
    "jax_layout": case(SNR_DATA, JAX_SNRS, bpd=JAX_FRAMES // 2, snr_axis="snr"),
}
CASES2 = {
    "data_1d": case(((2,), ("data",)), [1.0, 2.0], cfg=CRC_CFG),
    "snr_2d": case(((2, 1), ("snr", "data")), [1.0, 2.0], cfg=CRC_CFG, snr_axis="snr"),
}
CASES1 = {"data_1d": case(((1,), ("data",)), [1.0, 2.0], cfg=CRC_CFG)}


@pytest.fixture(scope="module")
def one_thread_ranks():
    """Spawned ranks read OMP_NUM_THREADS when torch starts."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = old


def _spawn(cases, n):
    per_rank = spawn(step_rank, n, "gloo", "cpu", args=(list(cases.values()),))
    return {name: [r[k] for r in per_rank] for k, name in enumerate(cases)}


@pytest.fixture(scope="module")
def ranks4(one_thread_ranks):
    return _spawn(CASES4, 4)


@pytest.fixture(scope="module")
def ranks2(one_thread_ranks):
    return _spawn(CASES2, 2)


@pytest.fixture(scope="module")
def ranks1(one_thread_ranks):
    return _spawn(CASES1, 1)


def recount(code, cfg, mesh_shape, axis_names, seed, snr_db, batch_per_device,
            snr_axis=None, **kw) -> dict:
    """The one-process recount: ``sim_step`` on the seed rule's generator of
    every (data position, local point), summed over the data axis; other
    axes counted once; ranks past the mesh count nothing."""
    sizes = dict(zip(axis_names, mesh_shape))
    n_s = sizes[snr_axis] if snr_axis else 1
    n_local = len(snr_db) // n_s
    enc = matmul_encode_fn(code, device="cpu")
    dec = make_decode_fn(code, cfg, device="cpu")
    out = {f: [0] * len(snr_db) for f in SimStats._fields}
    for s in range(n_s):
        for d in range(sizes["data"]):
            for i in range(n_local):
                st = sim_step(code, cfg, point_generator(seed, d * n_s + s, i, "cpu"),
                              snr_db[s * n_local + i], batch_per_device, enc, dec, **kw)
                for f in SimStats._fields:
                    out[f][s * n_local + i] += int(getattr(st, f))
    return out


def _check_ranks(per_rank, spec):
    """Every rank holds the same [num_snr] stats, equal to the recount."""
    assert all(r == per_rank[0] for r in per_rank)
    want = recount(**spec)
    assert per_rank[0] == want
    return want


@pytest.mark.parametrize("name", [n for n in CASES4 if n != "jax_layout"])
def test_four_ranks_equal_the_recount(ranks4, name):
    got = _check_ranks(ranks4[name], CASES4[name])
    spec = CASES4[name]
    n_data = dict(zip(spec["axis_names"], spec["mesh_shape"]))["data"]
    assert got["frames"] == [spec["batch_per_device"] * n_data] * len(spec["snr_db"])
    assert got["info_bits"] == [f * CODE.k for f in got["frames"]]


@pytest.mark.parametrize("name", list(CASES2))
def test_two_ranks_equal_the_recount(ranks2, name):
    _check_ranks(ranks2[name], CASES2[name])


def test_one_rank_group_equals_no_group(ranks1):
    """A spawned world of one gloo rank equals the world torchrun's absent
    environment gives (no group, no collective), and the recount."""
    world = init_from_env(device="cpu")
    assert world == pdist.World(0, 1, 0, torch.device("cpu"), None)
    spec = CASES1["data_1d"]
    alone = run_step(world, **spec)
    assert ranks1["data_1d"] == [{f: getattr(alone, f).tolist() for f in SimStats._fields}]
    _check_ranks(ranks1["data_1d"], spec)


def test_ranks_are_not_replicas(ranks4):
    """The data ranks draw their own noise (tests/test_parallel.py:70-81):
    four ranks' bit errors at 1 dB are not four times one rank's."""
    spec = dict(CASES4["data_1d"], mesh_shape=(1,))
    alone = run_step(init_from_env(device="cpu"), **spec)
    one = int(alone.bit_errors[0])
    assert one > 0
    assert ranks4["data_1d"][0]["bit_errors"][0] != 4 * one
    per_position = [int(sim_step(CODE, CFG, point_generator(5, d, 0, "cpu"), 1.0, 4,
                                 decode_fn=make_decode_fn(CODE, CFG, device="cpu")).bit_errors)
                    for d in range(4)]
    assert len(set(per_position)) > 1 and per_position[0] == one


def test_step_at_one_rank_is_sim_step_on_position_0():
    world = init_from_env(device="cpu")
    step = make_sharded_campaign_step(CODE, CFG, make_mesh(), 6, 2, device="cpu")
    got = step(9, [1.5, 2.5])
    for i, snr in enumerate((1.5, 2.5)):
        want = sim_step(CODE, CFG, point_generator(9, 0, i, "cpu"), snr, 6,
                        decode_fn=make_decode_fn(CODE, CFG, device=world.device))
        assert [int(getattr(got, f)[i]) for f in SimStats._fields] == [int(x) for x in want]
    assert all(x.dtype == torch.int64 and x.shape == (2,) for x in got)


@pytest.fixture(scope="module")
def reference_stats():
    """The JAX package's step on its (snr 2 x data 4) mesh of the 8 virtual
    devices, 512 frames a device: 2048 a point, as the port's 1024 on each
    of 2 data ranks."""
    code = ref_wimax(576, "1/2")
    mesh = ref_make_mesh((2, 4), ("snr", "data"))
    step = ref_step(code, RefDecoderConfig(max_iters=8), mesh,
                    batch_per_device=JAX_FRAMES // 4, num_snr=4, snr_axis="snr")
    stats = jax.jit(step)(jax.random.PRNGKey(5), jnp.asarray(JAX_SNRS, jnp.float32))
    return {f: np.asarray(getattr(stats, f)).tolist() for f in stats._fields}


def test_layout_matches_the_reference(ranks4, reference_stats):
    mine = ranks4["jax_layout"][0]
    assert all(r == mine for r in ranks4["jax_layout"])
    for stats in (mine, reference_stats):
        assert len(stats["frames"]) == 4
        assert stats["frames"] == [JAX_FRAMES] * 4
        # which SNR lands where: 30 dB clean, -10 dB every frame wrong
        assert stats["frame_errors"][0] == 0
        assert stats["frame_errors"][1] == JAX_FRAMES


@pytest.mark.parametrize("point", [0, 1], ids=["30dB", "-10dB"])
def test_stats_equal_the_reference(ranks4, reference_stats, point):
    """Every field equal at 30 dB (no errors) and at -10 dB (every frame
    unconverged after all 8 sweeps), but the -10 dB bit errors, which count
    different noise: within 6 binomial sigmas over the info bits."""
    mine = {f: v[point] for f, v in ranks4["jax_layout"][0].items()}
    ref = {f: v[point] for f, v in reference_stats.items()}
    if point == 1:
        assert mine["iterations"] == JAX_FRAMES * CFG.max_iters
        assert mine["unconverged"] == JAX_FRAMES
        n = mine["info_bits"]
        p = (mine["bit_errors"] + ref["bit_errors"]) / (2 * n)
        assert abs(mine.pop("bit_errors") - ref.pop("bit_errors")) <= 6 * math.sqrt(
            2 * n * p * (1 - p))
    assert mine == ref


def test_mid_snr_fer_within_binomial_bound(ranks4, reference_stats):
    """FER at 1.5 dB over 2 x 2048 frames each: within 5 sigmas of the
    difference of two binomial proportions (pooled p)."""
    mine, ref = ranks4["jax_layout"][0], reference_stats
    n = sum(mine["frames"][2:])
    assert n == sum(ref["frames"][2:]) == 2 * JAX_FRAMES
    p1, p2 = sum(mine["frame_errors"][2:]) / n, sum(ref["frame_errors"][2:]) / n
    p = (p1 + p2) / 2
    assert 0.2 < p < 0.8
    assert abs(p1 - p2) <= 5 * math.sqrt(p * (1 - p) * 2 / n)


def test_refusals_match_the_reference():
    ref_mesh = ref_make_mesh((2, 4), ("snr", "data"))
    with pytest.raises(ValueError, match="not divisible by snr mesh axis 2"):
        ref_step(ref_wimax(576, "1/2"), RefDecoderConfig(), ref_mesh, 2, 3,
                 snr_axis="snr")
    mesh = Mesh(("snr", "data"), (2, 2), 0)
    with pytest.raises(ValueError, match="not divisible by snr mesh axis 2"):
        make_sharded_campaign_step(CODE, CFG, mesh, 2, 3, snr_axis="snr", device="cpu")
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        ref_make_mesh((16,))
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh((2,))
    argv = ["waterfall", "--snr", "2", "--batch", "8", "--max-frames", "8"]
    with pytest.raises(SystemExit, match="--snr-shards 3 must divide device count 8"):
        ref_cli.main([*argv, "--snr-shards", "3"])
    with pytest.raises(SystemExit, match="--snr-shards 2 must divide the rank count 1"):
        cli.main([*argv, "--snr-shards", "2", "--device", "cpu"])


def test_a_failing_rank_fails_spawn(one_thread_ranks):
    """No rank failure is caught: a rank's exception fails the call."""
    bad = case(((2, 1), ("snr", "data")), [1.0, 2.0, 3.0], snr_axis="snr")
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="not divisible by snr mesh axis 2"):
        spawn(step_rank, 2, "gloo", "cpu", args=([bad],))


def test_backend_rule(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert pdist.choose_backend(None, cpu, 4) == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs ranks on CUDA"):
        pdist.choose_backend("nccl", cpu, 1)
    with pytest.raises(ValueError, match="unknown backend"):
        pdist.choose_backend("mpi", cpu, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pdist.choose_backend(None, cuda, 1) == "nccl"
    assert pdist.choose_backend("gloo", cuda, 4) == "gloo"
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="4 ranks share 1 CUDA device"):
            pdist.choose_backend(backend, cuda, 4)
    # entry points run on the card unless asked for the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_from_env()


def test_dryrun_mesh_is_the_reference_rule():
    assert multichip_mesh(4) == ((2, 2), ("snr", "data"), "snr", 4)
    assert multichip_mesh(3) == ((3,), ("data",), None, 2)
    assert multichip_mesh(1) == ((1,), ("data",), None, 2)


def _recount_campaign(campaign_kw):
    """The campaign the 2-rank CLI runs, on the recount's step in one
    process: groups of 2 points on (snr 2 x data 1), 16 frames a rank."""
    cfg = DecoderConfig(max_iters=8)

    def step_fn(seed, snrs):
        got = recount(CODE, cfg, (2, 1), ("snr", "data"), seed, snrs, 16,
                      snr_axis="snr")
        return SimStats(*(np.asarray(got[f]) for f in SimStats._fields))

    camp = WaterfallCampaign(CampaignConfig(**campaign_kw), step_fn, 16,
                             snr_group_size=2)
    camp.run()
    return camp


def test_cli_under_torchrun_two_ranks(tmp_path, one_thread_ranks):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    myldpccppapi_torch -- waterfall --snr-shards 2``: rank 0 alone prints and
    writes --out and the checkpoint; the points equal the same campaign on
    the one-process recount."""
    out, ck = tmp_path / "wf.csv", tmp_path / "ck.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "myldpccppapi_torch", "--", "waterfall",
           "--family", "wimax", "--n", "576", "--rate", "1/2", "--snr", "1,2,3",
           "--batch", "16", "--max-iters", "8", "--target-errors", "8",
           "--max-frames", "48", "--snr-shards", "2", "--device", "cpu",
           "--out", str(out), "--checkpoint", str(ck)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("snr=")]
    assert [ln.split()[0] for ln in lines] == ["snr=+1.00", "snr=+2.00", "snr=+3.00"]
    camp = _recount_campaign(dict(snr_db=(1.0, 2.0, 3.0), batch_per_step=16,
                                  min_frame_errors=8, max_frames=48))
    rows = [ln.split(",") for ln in out.read_text().splitlines()]
    header = rows[0]
    keep = [header.index(c) for c in header if c != "wall_s"]
    want = [[str(p.as_dict()[header[k]]) for k in keep] for p in camp.points]
    assert [[r[k] for k in keep] for r in rows[1:]] == want
    assert ck.exists()
