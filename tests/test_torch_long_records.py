"""The rebuilt shared-placement sweep (csrc/bp_long.cu) emulated on the CPU.

``csrc/bp_long.cu`` runs only on a card (chip_smoke.py holds it there
against ``cuda_long.decode_qc_long_plain``).  :func:`records_decode` below
replays its sweep in torch, every codeword with its own block's loop:

* min-sum R is one record per (layer, row) (``cuda_stream``'s codec of
  ``record.cuh``), rebuilt into r_old at the layer; pass 2 takes each
  edge's r_new from the new record;
* the next layer's record is fetched at the start of this layer (layer 0's
  during the last layer of a sweep, unless no sweep follows; with one
  layer, the record just made), so a record read a layer early must be
  the one the next layer would read;
* sum-product keeps R per edge and caches phi(|q|) of each edge for pass
  2's phi(total - phi(|q|)), the total a left fold in edge order;
* a lone circulant's delta is added in place, a multi-edge cell's deltas
  by the owner of each variable in block order, P rounded once; a masked
  row enters at q = 1e30 and writes nothing;
* the exact syndrome stops at a thread's first failing row; lazy latches
  only on a sweep whose on-the-fly parity passed.

It is held bit-exact (bits, converged, iterations, total_iters,
posteriors) against ``decode_qc_long_plain`` on a random QC code with a
multi-edge cell and a masked row, on nr_code(64, 1) with LLR-0 punctured
columns and on nr_code(64, 2), in f32 and bf16, exact and lazy, early
exit on and off, and at max_iters = 0; and against the JAX package's TPU
kernel ``decode_qc_zlane`` in interpret mode (min-sum f32 and bf16,
posteriors included; sum-product to equal hard outputs at a converging
point, as its exp/log1p are XLA's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.ops.pallas_zlane import decode_qc_zlane

from myldpccppapi_torch import DecoderConfig, QCCode, interop, nr_code
from myldpccppapi_torch.ops import bp, cuda_long, cuda_stream
from myldpccppapi_torch.ops.bp import DecodeResult

from test_torch_long import _all_zero_llr, _nr_llr, _random_qc

torch.set_num_threads(1)

FIELDS = ("bits", "converged", "iterations", "total_iters")


def records_decode(code, cfg, llr: torch.Tensor) -> DecodeResult:
    """bp_long.cu's sweep in torch (module docstring): P [B, n_b, z] in the
    message type, R as records [words, z, B] per layer (min-sum) or
    messages [z, B] per edge (sum-product), codeword b's block running
    while t < max_iters and not (early exit and done)."""
    z, m_b, n_b = code.z, code.m_b, code.n_b
    dt = bp.msg_dtype(cfg)
    sp = cfg.algorithm == "sum-product"
    lazy = cfg.syndrome_mode == "lazy"
    layers = bp._layers(code)
    masks = bp._masks(code, llr.device)
    alphas, betas = bp.layer_weights(cfg.normalization, cfg.offset, m_b)
    words = cuda_stream.record_words(code.max_row_degree, dt.itemsize)
    batch = llr.shape[0]
    P = llr.to(dt).reshape(batch, n_b, z).permute(1, 2, 0).clone()  # [n_b, z, B]
    zero_rec = torch.zeros((words, z, batch), dtype=torch.int32)
    R = {}
    for i, (p0, entries) in enumerate(layers):
        R[i] = zero_rec.clone()
        for (e, _, _, _) in entries:
            R[("e", e)] = torch.zeros((z, batch), dtype=dt)
    done = torch.zeros(batch, dtype=torch.bool)
    it = torch.zeros(batch, dtype=torch.int32)
    executed = torch.zeros(batch, dtype=torch.int32)
    bits_out = torch.zeros((n_b, z, batch), dtype=torch.bool)
    post_out = P.clone()
    nxt = zero_rec.clone()                      # min-sum: the next layer's record
    r_sp = [torch.zeros((z, batch), dtype=dt)   # sum-product: its r_old
            for _ in layers[0][1]]
    t = 0
    while True:
        active = torch.full((batch,), t < cfg.max_iters) & ~(cfg.early_exit & done)
        if not active.any():
            break
        pre_bad = torch.zeros(batch, dtype=torch.bool)
        for i, (p0, entries) in enumerate(layers):
            deg = len(entries)
            last = i + 1 == m_b
            i_next = 0 if last else i + 1
            have_next = t + 1 < cfg.max_iters if last else t > 0
            cur = nxt
            nxt = R[i_next].clone() if have_next and m_b > 1 else zero_rec.clone()
            live = torch.stack([masks.get(e, torch.ones((z, 1), dtype=torch.bool))
                                for (e, _, _, _) in entries])  # [deg, z, 1]
            r_old = (torch.stack(r_sp[:deg]) if sp
                     else cuda_stream.expand_min_sum(cur, deg, dt))
            x = torch.stack([torch.roll(P[j], -s, 0) for (_, j, s, _) in entries])
            q = torch.where(live, x.float() - r_old.float(), 1e30)
            pre_bad |= ((((x <= 0) & live).sum(0) % 2) == 1).any(0)
            if sp:
                phi_q = bp._phi(q.abs())  # pass 1's phi(|q|), kept for pass 2
                total = phi_q[0]
                for k in range(1, deg):
                    total = total + phi_q[k]
                neg = (q < 0).to(torch.int64)
                sign = (neg.sum(0) & 1) ^ neg
                mag = bp._phi(total - phi_q)
                r_new = torch.where(sign == 1, -mag, mag).to(dt)
                for k, (e, _, _, _) in enumerate(entries):
                    R[("e", e)] = torch.where(live[k] & active, r_new[k], R[("e", e)])
            else:
                rec = cuda_stream.compress_min_sum(q, alphas[i], betas[i], dt,
                                                   code.max_row_degree)
                R[i] = torch.where(active, rec, R[i])
                if m_b == 1 and have_next:
                    nxt = R[i].clone()
                r_new = cuda_stream.expand_min_sum(rec, deg, dt)
            delta = torch.where(live, r_new.float() - r_old.float(), 0.0)
            for (j, group) in bp._column_groups(entries):
                if len(group) == 1:  # in place; a masked row keeps its value
                    k, _, s = group[0]
                    upd = torch.roll(torch.where(live[k], (x[k].float() + delta[k]).to(dt),
                                                 x[k]), s, 0)
                else:  # the owner adds the cell's deltas in block order
                    acc = P[j].float()
                    for (k, _, s) in group:
                        acc = acc + torch.roll(delta[k], s, 0)
                    upd = acc.to(dt)
                P[j] = torch.where(active, upd, P[j])
            if sp:
                r_sp = [R[("e", e)].clone() if have_next else torch.zeros((z, batch), dtype=dt)
                        for (e, _, _, _) in layers[i_next][1]]
        check = active & ~done & ~(lazy & pre_bad)
        hard = P <= 0
        fail = torch.zeros(batch, dtype=torch.bool)
        for (_, entries) in layers:  # up to the first failing row: the same OR
            par = torch.zeros((z, batch), dtype=torch.bool)
            for (e, j, s, _) in entries:
                par ^= torch.roll(hard[j], -s, 0) & masks.get(e, torch.ones((z, 1),
                                                                          dtype=torch.bool))
            fail |= par.any(0)
        it = torch.where(active & ~done, t + 1, it)
        latch = check & ~fail
        bits_out = torch.where(latch, hard, bits_out)
        post_out = torch.where(latch, P, post_out)
        done |= latch
        executed += active.to(torch.int32)
        t += 1
    bits_out = torch.where(done, bits_out, (P <= 0) & (executed > 0))
    post_out = torch.where(done, post_out, P)
    flat = lambda a: a.permute(2, 0, 1).reshape(batch, -1)  # noqa: E731
    return DecodeResult(bits=flat(bits_out).to(torch.uint8), converged=done, iterations=it,
                        total_iters=executed.max(),
                        posteriors=flat(post_out).contiguous() if cfg.soft_output else None)


def raw(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def assert_same(got, want, soft: bool) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)).astype(np.int64),
                                      np.asarray(getattr(want, f)).astype(np.int64),
                                      err_msg=f)
    if soft:
        want_post = want.posteriors
        if not isinstance(want_post, torch.Tensor):
            want_post = torch.from_numpy(np.array(want_post.astype(jnp.float32)))
            want_post = want_post.to(got.posteriors.dtype)
        assert torch.equal(raw(got.posteriors), raw(want_post))


@pytest.fixture(scope="module")
def inputs():
    rcode = _random_qc(64, extra=True, masked=True)
    special = interop.code_from_reference(rcode)
    return {
        "special": (special, rcode, torch.from_numpy(_all_zero_llr(special.n, 6, seed=71))),
        "nr1": (nr_code(64, 1), None, _nr_llr(64, 1, 4, -0.75, seed=72)),
        "nr2": (nr_code(64, 2), None, _nr_llr(64, 2, 4, -2.5, seed=73)),
    }


MODES = {
    "exact": dict(normalization=0.8, max_iters=10),
    "exact no exit soft": dict(normalization=0.8, max_iters=10, early_exit=False,
                               soft_output=True),
    "lazy soft": dict(normalization=0.8, max_iters=10, syndrome_mode="lazy", soft_output=True),
    "lazy no exit offset": dict(normalization=0.75, offset=0.25, max_iters=10,
                                syndrome_mode="lazy", early_exit=False),
    "bf16 soft": dict(normalization=0.8, max_iters=10, msg_dtype="bfloat16", soft_output=True),
    "bf16 lazy no exit": dict(normalization=0.8, max_iters=10, msg_dtype="bfloat16",
                              syndrome_mode="lazy", early_exit=False, soft_output=True),
    "sum-product soft": dict(algorithm="sum-product", max_iters=6, soft_output=True),
    "sum-product bf16 lazy no exit": dict(algorithm="sum-product", max_iters=6,
                                          msg_dtype="bfloat16", syndrome_mode="lazy",
                                          early_exit=False, soft_output=True),
    "max_iters 0": dict(normalization=0.8, max_iters=0, soft_output=True),
}


#: the modes each code runs: every one on the multi-edge / masked code, and
#: between them every one on NR, whose punctured columns start at LLR +-0
CASES = ([("special", mode) for mode in MODES]
         + [("nr1", mode) for mode in ("exact", "exact no exit soft", "lazy soft", "bf16 soft",
                                       "sum-product soft", "max_iters 0")]
         + [("nr2", mode) for mode in ("exact", "lazy no exit offset", "bf16 lazy no exit",
                                       "sum-product bf16 lazy no exit")])


@pytest.mark.parametrize("which,mode", CASES)
def test_record_sweep_equals_plain_version(which, mode, inputs):
    code, _, llr = inputs[which]
    cfg = DecoderConfig(**MODES[mode])
    got = records_decode(code, cfg, llr)
    want = cuda_long.decode_qc_long_plain(code, cfg, llr)
    assert_same(got, want, cfg.soft_output)
    if mode == "exact":  # frames that converge and frames that run out
        assert 0 < got.converged.sum() < len(got.converged)


def test_one_layer_record_is_forwarded():
    """With one layer, the next layer's record is the one just made: the
    sweep copies it (a load at the layer's start would read the previous
    sweep's)."""
    code = QCCode(name="one_layer", base=np.array([[0, 5, 17, 40, 63]], dtype=np.int32), z=64)
    llr = torch.from_numpy(_all_zero_llr(code.n, 3, seed=74, lo=2.0))
    for kw in (dict(normalization=0.8), dict(algorithm="sum-product")):
        cfg = DecoderConfig(max_iters=6, early_exit=False, soft_output=True, **kw)
        assert_same(records_decode(code, cfg, llr), cuda_long.decode_qc_long_plain(code, cfg, llr),
                    soft=True)


@pytest.mark.parametrize("mode", ["exact soft", "bf16 lazy soft", "sum-product"])
def test_record_sweep_equals_zlane_kernel(mode, inputs):
    """Against the TPU kernel in interpret mode on the same NumPy LLRs: min-sum
    bit for bit, posteriors included (bf16 at kernel C's rounding points);
    lazy to the reference's contract (its 8-codeword tile decides when the
    exact pass runs, so converged frames have a zero syndrome and take at
    least as many sweeps as exact); sum-product to equal hard outputs at a
    converging point."""
    code, rcode, _ = inputs["special"]
    kw = {"exact soft": dict(normalization=0.75, soft_output=True),
          "bf16 lazy soft": dict(normalization=0.75, soft_output=True, msg_dtype="bfloat16",
                                 syndrome_mode="lazy"),
          "sum-product": dict(algorithm="sum-product", max_iters=5)}[mode]
    kw.setdefault("max_iters", 8)
    llr = _all_zero_llr(code.n, 8, seed=75, lo=4.0 if mode == "sum-product" else 1.0)
    got = records_decode(code, DecoderConfig(**kw), torch.from_numpy(llr))
    want = decode_qc_zlane(rcode, ref.DecoderConfig(schedule="layered", **kw),
                           jnp.asarray(llr), True)
    if mode == "sum-product":
        assert got.converged.all()
        for f in ("bits", "converged"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)), err_msg=f)
    elif "lazy" in mode:
        exact = records_decode(code, DecoderConfig(**dict(kw, syndrome_mode="exact")),
                               torch.from_numpy(llr))
        for res in (got, want):
            conv = np.asarray(res.converged)
            bits = torch.from_numpy(np.array(res.bits)).bool()
            blocks = bits.reshape(-1, code.n_b, code.z).permute(1, 2, 0)
            assert not bp._syndrome_fail(blocks, code).numpy()[conv].any()
            it = np.asarray(res.iterations)[conv]
            assert (it >= exact.iterations.numpy()[conv]).all()
        assert got.converged.any()
    else:
        assert_same(got, want, kw.get("soft_output", False))


def test_scratch_bytes_asks_the_library(monkeypatch):
    """The wrapper sizes R by the library's own query, passing z, m_b,
    num_blocks, the widest row, the algorithm and the message size in that
    order, and refuses an answer below one byte.  The layout itself is the
    library's; chip_smoke.py's phase 2 holds it against the record codec
    on the card."""
    calls = []
    answer = [12345]

    class Lib:
        def ldpc_bp_long_scratch_bytes(self, *args):
            calls.append(args)
            return answer[0]

    monkeypatch.setattr(cuda_long._build, "load", lambda: Lib())
    cuda_long.scratch_bytes.cache_clear()
    try:
        code = nr_code(384, 1)
        assert cuda_long.scratch_bytes(code, False, 4) == 12345
        assert cuda_long.scratch_bytes(code, True, 2) == 12345
        assert calls == [(384, code.m_b, code.num_blocks, code.max_row_degree, 0, 4),
                         (384, code.m_b, code.num_blocks, code.max_row_degree, 1, 2)]
        answer[0] = 0
        with pytest.raises(RuntimeError, match="scratch query"):
            cuda_long.scratch_bytes(code, False, 2)
    finally:
        cuda_long.scratch_bytes.cache_clear()
