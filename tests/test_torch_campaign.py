"""The port's waterfall machinery (campaign/waterfall.py, sim.py, CLI
``waterfall``) against the JAX package on the CPU."""
import itertools
import json
import time

import numpy as np
import pytest
import torch

from myldpccppapi_tpu.campaign import CampaignConfig as RefCampaignConfig
from myldpccppapi_tpu.campaign import WaterfallCampaign as RefCampaign
from myldpccppapi_tpu.parallel.sim import SimStats as RefSimStats

from myldpccppapi_torch import DecoderConfig, Encoder, cli, wimax
from myldpccppapi_torch.campaign import CampaignConfig, WaterfallCampaign
from myldpccppapi_torch.codes import nr_code, triangular_encode_fn
from myldpccppapi_torch.ops.bp import decode_layered
from myldpccppapi_torch.ops.channel import channel_llr, sigma_from_snr_db
from myldpccppapi_torch.sim import SimStats, make_decode_fn, sim_step

torch.set_num_threads(1)

SNRS = (1.0, 2.0, 3.0)
#: per SNR: frame errors per 100-frame step (a function of the seed too, so
#: the per-(point, step) seed schedule shows in the results)
ERRORS = {1.0: 40, 2.0: 7, 3.0: 0}


def _step(stats_type):
    def step(seed, snr_db):
        fe = ERRORS[float(snr_db)] + seed % 3 * (ERRORS[float(snr_db)] > 0)
        return stats_type(
            frames=np.int64(100), frame_errors=np.int64(fe),
            bit_errors=np.int64(fe * 3 + seed % 5), info_bits=np.int64(100 * 432),
            iterations=np.int64(500 + seed % 7), unconverged=np.int64(fe),
            undetected_errors=np.int64(seed % 2 * (fe > 0)),
            crc_rejected=np.int64(0))
    return step


@pytest.fixture
def fake_clock(monkeypatch):
    """A perf_counter that advances 0.25 s per read, so wall_s is the same
    in both campaigns."""
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 0.25)


@pytest.mark.parametrize("seed", [0, 11])
def test_campaign_matches_reference(tmp_path, fake_clock, seed):
    kw = dict(snr_db=SNRS, batch_per_step=100, min_frame_errors=50,
              max_frames=1000, seed=seed)
    mine = WaterfallCampaign(CampaignConfig(**kw), _step(SimStats), 100,
                             fingerprint="fp", checkpoint_path=str(tmp_path / "a.json"))
    theirs = RefCampaign(RefCampaignConfig(**kw), _step(RefSimStats), 100,
                         fingerprint="fp", checkpoint_path=str(tmp_path / "b.json"))
    assert mine.config.fingerprint("c", "d") == theirs.config.fingerprint("c", "d")
    mine.run(checkpoint_every=2)
    theirs.run(checkpoint_every=2)
    assert [p.as_dict() for p in mine.points] == [p.as_dict() for p in theirs.points]
    assert mine.steps_done == theirs.steps_done
    assert [mine.point_finished(i) for i in range(3)] == [
        theirs.point_finished(i) for i in range(3)] == [True] * 3
    # the first point stops on frame errors, the last on max_frames
    assert mine.points[0].frame_errors >= 50 > mine.points[2].frame_errors
    assert mine.points[0].frames < 1000 == mine.points[2].frames
    assert json.loads((tmp_path / "a.json").read_text()) == json.loads(
        (tmp_path / "b.json").read_text())
    mine.write_csv(str(tmp_path / "a.csv"))
    theirs.write_csv(str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    assert mine.report() == theirs.report()


def _group_step(stats_type):
    """The fake step over a group of SNR points: [group]-leading stats, a
    point's seed offset by its place in the group."""
    one = _step(stats_type)

    def step(seed, snrs):
        rows = [one(seed + 13 * pos, snr) for pos, snr in enumerate(snrs)]
        return stats_type(*(np.asarray([r[k] for r in rows])
                            for k in range(len(stats_type._fields))))
    return step


@pytest.mark.parametrize("group", [2, 3])
def test_grouped_campaign_matches_reference(tmp_path, fake_clock, group):
    """snr_group_size: groups of points per step (a short tail group padded
    with its last point), finished members stepping on as discarded filler
    with their steps_done kept aligned; then a resume from the checkpoint
    runs no step."""
    kw = dict(snr_db=SNRS, batch_per_step=100, min_frame_errors=50,
              max_frames=800, seed=3)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    mine = WaterfallCampaign(CampaignConfig(**kw), _group_step(SimStats), 100,
                             fingerprint="fp", checkpoint_path=a,
                             snr_group_size=group)
    theirs = RefCampaign(RefCampaignConfig(**kw), _group_step(RefSimStats), 100,
                         fingerprint="fp", checkpoint_path=b, snr_group_size=group)
    mine.run(checkpoint_every=2)
    theirs.run(checkpoint_every=2)
    assert [p.as_dict() for p in mine.points] == [p.as_dict() for p in theirs.points]
    assert mine.steps_done == theirs.steps_done
    # a group steps together: its members' seeds stay aligned
    assert len(set(mine.steps_done[:group])) == 1
    assert mine.points[0].frames < mine.points[2].frames == 800
    assert json.loads((tmp_path / "a.json").read_text()) == json.loads(
        (tmp_path / "b.json").read_text())

    def no_step(seed, snrs):
        raise AssertionError("a resumed, finished campaign ran a step")

    resumed = WaterfallCampaign(CampaignConfig(**kw), no_step, 100, fingerprint="fp",
                                checkpoint_path=a, snr_group_size=group)
    assert resumed.run() == mine.points


def test_only_rank_0_writes_the_checkpoint(tmp_path):
    """Every rank of a multi-process campaign loads the checkpoint; only
    rank 0 writes it."""
    kw = dict(snr_db=SNRS, batch_per_step=100, min_frame_errors=50, max_frames=600)
    path = tmp_path / "ck.json"
    other = WaterfallCampaign(CampaignConfig(**kw), _step(SimStats), 100,
                              fingerprint="fp", checkpoint_path=str(path), rank=1)
    other.run()
    assert not path.exists()
    lead = WaterfallCampaign(CampaignConfig(**kw), _step(SimStats), 100,
                             fingerprint="fp", checkpoint_path=str(path), rank=0)
    lead.run()
    loaded = WaterfallCampaign(CampaignConfig(**kw), _step(SimStats), 100,
                               fingerprint="fp", checkpoint_path=str(path), rank=1)
    assert loaded.finished and loaded.steps_done == lead.steps_done == other.steps_done


def test_resume_runs_no_new_steps(tmp_path):
    kw = dict(snr_db=SNRS, batch_per_step=100, min_frame_errors=50,
              max_frames=600)
    path = str(tmp_path / "ck.json")
    first = WaterfallCampaign(CampaignConfig(**kw), _step(SimStats), 100,
                              fingerprint="fp", checkpoint_path=path)
    first.run()

    def no_step(seed, snr_db):
        raise AssertionError("a resumed, finished campaign ran a step")

    resumed = WaterfallCampaign(CampaignConfig(**kw), no_step, 100,
                                fingerprint="fp", checkpoint_path=path)
    assert resumed.finished
    resumed.run()
    assert [p.as_dict() for p in resumed.points] == [p.as_dict() for p in first.points]
    # another campaign's checkpoint is ignored: it starts fresh
    other = WaterfallCampaign(CampaignConfig(**kw), _step(SimStats), 100,
                              fingerprint="other", checkpoint_path=path)
    assert other.steps_done == [0, 0, 0]


def test_frames_per_step_mismatch_raises():
    camp = WaterfallCampaign(CampaignConfig(snr_db=(1.0,)), _step(SimStats), 64)
    with pytest.raises(ValueError, match="frames_per_step"):
        camp.run()


def _recount(code, cfg, state, snr_db, batch, encode):
    """sim_step's counts recomputed with NumPy from the same generator
    draws: [batch, k] info bits, then [batch, n] normal noise."""
    gen = torch.Generator().manual_seed(0)
    gen.set_state(state)
    u = torch.randint(0, 2, (batch, code.k), generator=gen, dtype=torch.uint8)
    cw = encode(u)
    noise = torch.randn(cw.shape, generator=gen, dtype=torch.float32)
    sigma = sigma_from_snr_db(snr_db)
    llr = channel_llr(1.0 - 2.0 * cw.to(torch.float32) + sigma * noise, sigma)
    res = decode_layered(code, cfg, llr)
    bits = res.bits.numpy()[:, : code.k]
    conv = res.converged.numpy()
    bit_err = (bits != u.numpy()).sum(axis=1)
    return dict(frames=batch, frame_errors=int((bit_err > 0).sum()),
                bit_errors=int(bit_err.sum()), info_bits=batch * code.k,
                iterations=int(res.iterations.numpy().sum()),
                unconverged=int((~conv).sum()),
                undetected_errors=int(((bit_err > 0) & conv).sum()),
                crc_rejected=0)


@pytest.mark.parametrize("family", ["wimax", "nr"])
def test_sim_step_counts_match_a_numpy_recount(family):
    if family == "wimax":
        code, snr = wimax(576, "1/2"), 1.5
        encode = Encoder(code, device="cpu")
    else:
        code, snr = nr_code(16, 1), -1.0
        encode = triangular_encode_fn(code)
    cfg = DecoderConfig(normalization=0.8, max_iters=8)
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    stats = sim_step(code, cfg, gen, snr, 24, encode_fn=encode)
    got = {k: int(v) for k, v in stats._asdict().items()}
    assert got == _recount(code, cfg, state, snr, 24, encode)
    assert 0 < got["frame_errors"] < 24  # the snr sits in the waterfall


def test_sim_step_refuses_unported_branches():
    """The CRC and outer-code branches, ported since, run (a clean point:
    nothing is rejected); crc with an outer code, another outer code, the
    reference's llr_scale and BICM-ID on BPSK are refused."""
    code = wimax(576, "1/2")
    gen = torch.Generator().manual_seed(0)
    for ported in (dict(crc="16"), dict(outer=("bch", 16, 12))):
        stats = sim_step(code, DecoderConfig(**ported), gen, 8.0, 4,
                         decode_fn=make_decode_fn(code, DecoderConfig(**ported),
                                                  device="cpu"))
        assert int(stats.frames) == 4 and int(stats.frame_errors) == 0
        assert int(stats.crc_rejected) == 0
    with pytest.raises(ValueError, match="either"):
        sim_step(code, DecoderConfig(crc="16"), gen, 2.0, 4, outer=("bch", 16, 12))
    with pytest.raises(ValueError, match="unknown outer"):
        sim_step(code, DecoderConfig(), gen, 2.0, 4, outer=("rs", 1, 2))
    # the reference's llr_scale is not ported (no caller sets it)
    with pytest.raises(TypeError):
        sim_step(code, DecoderConfig(), gen, 2.0, 4, llr_scale=1.0)
    # BICM-ID needs a constellation other than BPSK, as in the reference
    with pytest.raises(ValueError, match="non-BPSK"):
        sim_step(code, DecoderConfig(), gen, 2.0, 4, id_outer=2)


@pytest.mark.parametrize("family", ["wimax", "nr"])
def test_cli_waterfall_and_resume(tmp_path, capsys, family):
    ck, out = tmp_path / "ck.json", tmp_path / "wf.csv"
    code_args = (["--family", "nr", "--z", "16", "--bg", "2"] if family == "nr"
                 else ["--family", "wimax", "--n", "576", "--rate", "1/2"])
    argv = ["waterfall", *code_args, "--snr=-1,0.5", "--batch", "16",
            "--target-errors", "4", "--max-frames", "48", "--max-iters", "8",
            "--normalization", "0.8", "--checkpoint", str(ck),
            "--out", str(out), "--device", "cpu"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["snr=-1.00", "snr=+0.50"]
    assert all("FER=" in ln and "BER=" in ln and "iters=" in ln for ln in lines)
    state = json.loads(ck.read_text())
    assert sum(state["steps_done"]) >= 2
    csv = out.read_text()
    assert csv.splitlines()[0].startswith("snr_db,frames,frame_errors")
    # rerun from the checkpoint: nothing left to simulate
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.strip().splitlines() == lines
    assert json.loads(ck.read_text()) == state
    assert cli.main([*argv[:-4], "--out", str(tmp_path / "wf.json"),
                     "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "wf.json").read_text())
    assert [p["snr_db"] for p in report["points"]] == [-1.0, 0.5]
