"""Learned min-sum weights in the port against the JAX package on the CPU:
the weight-schedule plumbing, per-iteration decodes on the torch path, the
differentiable unrolled decoder (posteriors, loss, gradients with ties and
zeros), the training step against a replica of the reference's, the
trainer, and the kernels' refusal of per-iteration schedules.

Tolerances: the per-iteration decodes and the unrolled posteriors are
bit-exact (the same f32 operations in the same order).  The loss and the
gradients go through reductions and ``exp``/``log1p``, which XLA and torch
round otherwise: the loss is held to rtol 1e-5, the gradients to rtol 1e-4
plus atol 1e-5 of their largest magnitude (measured: 2e-6 of it).  The
training step's losses are held to rtol 1e-5 and its weights to atol 1e-5
(Adam moves a weight by about lr = 0.02 a step)."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import rs_ldpc as ref_rs_ldpc
from myldpccppapi_tpu.ops import bp as ref_bp
from myldpccppapi_tpu.ops import learned as ref_learned

from myldpccppapi_torch import interop
from myldpccppapi_torch.codes import encode_numpy, nr_code, rs_ldpc, ru_precompute, wimax
from myldpccppapi_torch.decoder import Decoder, _implementation
from myldpccppapi_torch.ops import bp, cuda_bp, cuda_long, learned
from myldpccppapi_torch.utils.config import DecoderConfig, check_edgelist_config

torch.set_num_threads(1)

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
FIELDS = ("bits", "converged", "iterations", "total_iters", "posteriors")
CODE = wimax(576, "1/2")
REF_CODE = ref.wimax(576, "1/2")


def _stored(name):
    with open(BENCH / f"learned_weights_{name}.json") as f:
        d = json.load(f)
    return (np.asarray(d["alpha"], np.float32), np.asarray(d["beta"], np.float32),
            d["final_loss"])


def _small_codes():
    """A z=8 code with multi-edge cells and a masked row, and the xor
    group's rs_ldpc(4, 4, 8): (port code, reference code) pairs."""
    base = np.array([[0, 1, 2, 3, 4, 5], [0, 2, 4, 6, 1, 3], [0, 3, 6, 1, 4, 7]],
                    dtype=np.int32)
    kw = dict(name="odd_z8", base=base, z=8, extra_blocks=((0, 0, 4), (1, 3, 2)),
              masked_rows=(((2, 1, 3), (0, 5)),))
    return {"odd_z8": (interop.code_from_reference(ref.QCCode(**kw)), ref.QCCode(**kw)),
            "rs_ldpc_4_4_8": (rs_ldpc(4, 4, 8), ref_rs_ldpc(4, 4, 8))}


SMALL = _small_codes()


def _llr(code, snr_db, batch, seed):
    rng = np.random.default_rng(seed)
    mats = getattr(code, "encoder_matrices", None) or ru_precompute(code)
    u = rng.integers(0, 2, size=(batch, mats.w.shape[1]), dtype=np.uint8)
    c = encode_numpy(mats, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def _tied_llr(n, batch, seed):
    """All-zero-codeword LLRs on a grid of 0.5 with exact zeros, so rows
    hold tied minima, q = 0 and (with beta 0.5) mag == beta."""
    rng = np.random.default_rng(seed)
    llr = np.round(2.0 * (1.0 + 1.5 * rng.standard_normal((batch, n)))) / 2.0
    llr[:, ::7] = 0.0
    return llr.astype(np.float32)


# ---------------------------------------------------------------------------
# weight schedules
# ---------------------------------------------------------------------------

WEIGHTS = [
    0.75,
    tuple(0.6 + 0.03 * i for i in range(12)),
    ((0.7,), 0.8, tuple(0.5 + 0.04 * i for i in range(12))),
    ((0.7,) * 12,) * 3,
    (0.7, 0.8),                 # wrong per-layer length
    ((0.7, 0.8), (0.9,)),       # wrong per-iteration row length
]


@pytest.mark.parametrize("w", WEIGHTS, ids=range(len(WEIGHTS)))
def test_canon_weights_and_mode_match_reference(w):
    try:
        want = ref_bp.canon_weights(w, 12)
    except ValueError:
        with pytest.raises(ValueError):
            bp.canon_weights(w, 12)
        return
    assert bp.canon_weights(w, 12) == want
    for f in ("normalization", "offset"):
        mine = DecoderConfig(**{f: w})
        theirs = ref.DecoderConfig(**{f: w})
        assert mine == interop.config_from_reference(theirs)
        assert bp.weights_mode(mine, 12) == ref_bp.weights_mode(theirs, 12)


# ---------------------------------------------------------------------------
# per-iteration decodes on the torch path
# ---------------------------------------------------------------------------

def _t10():
    alpha, _, _ = _stored("wimax576_r12_T10")
    return tuple(tuple(float(x) for x in row) for row in alpha)


PER_ITER = {
    # the stored schedule, 2 sweeps past its end (its last row again)
    "T10 layered": dict(normalization=_t10(), max_iters=12, soft_output=True),
    "T10 flooding": dict(schedule="flooding", normalization=_t10(), max_iters=12,
                         soft_output=True),
    # inner scalars and length-1 rows, a per-iteration offset beside a
    # per-layer alpha
    "mixed offsets": dict(normalization=tuple(0.6 + 0.02 * i for i in range(12)),
                          offset=((0.1,), 0.0, tuple(0.05 * (i % 3) for i in range(12))),
                          max_iters=15, soft_output=True),
}


@pytest.mark.parametrize("case", list(PER_ITER))
def test_per_iteration_decode_bitexact(case):
    kw = PER_ITER[case]
    llr = _llr(CODE, 1.5, 64, seed=3)
    mine = Decoder(CODE, DecoderConfig(**kw), device="cpu")
    assert mine.implementation == "torch"
    assert bp.weights_mode(mine.config, CODE.m_b) == "iter"
    got = mine(llr)
    want = ref.Decoder(REF_CODE, ref.DecoderConfig(**kw))(jnp.asarray(llr))
    assert 0 < int(np.asarray(want.converged).sum()) < 64
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------------------
# the unrolled decoder, its loss and gradients
# ---------------------------------------------------------------------------

def _params(m_b, rows, seed, beta=0.0):
    rng = np.random.default_rng(seed)
    alpha = (0.6 + 0.4 * rng.random((rows, m_b))).astype(np.float32)
    alpha[0, 0] = 1.0
    betas = np.full((rows, m_b), beta, np.float32)
    return alpha, betas


@pytest.mark.parametrize("name,schedule,beta,T", [
    ("odd_z8", "layered", 0.0, 2), ("odd_z8", "layered", 0.5, 3),
    ("odd_z8", "flooding", 0.5, 2), ("rs_ldpc_4_4_8", "layered", 0.5, 2)])
def test_unrolled_posteriors_loss_and_grads_match_reference(name, schedule, beta, T):
    code, ref_code = SMALL[name]
    llr = _tied_llr(code.n, 12, seed=5)
    cw = np.zeros((12, code.n), np.float32)
    alpha, betas = _params(code.m_b, T, seed=6, beta=beta)
    run_r = ref_learned.make_unrolled(ref_code, T, schedule)

    def loss_fn(a, b):
        posts = run_r({"alpha": a, "beta": b}, jnp.asarray(llr))
        return ref_learned.soft_ber_loss(posts, jnp.asarray(cw)), posts

    (want_loss, want_post), (ga, gb) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(jnp.asarray(alpha), jnp.asarray(betas))
    a = torch.tensor(alpha, requires_grad=True)
    b = torch.tensor(betas, requires_grad=True)
    posts = learned.make_unrolled(code, T, schedule)({"alpha": a, "beta": b},
                                                     torch.from_numpy(llr))
    np.testing.assert_array_equal(posts.detach().numpy(), np.asarray(want_post))
    loss = learned.soft_ber_loss(posts, torch.from_numpy(cw))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for got, want in ((a.grad, ga), (b.grad, gb)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_unrolled_matches_decode_when_nothing_converges():
    """At -2 dB no frame converges in 4 sweeps: the unrolled decoder's last
    posterior is the soft-output decode's, bit for bit (wimax 576 r1/2,
    the tied per-layer form on the port's both sides)."""
    T = 4
    llr = _llr(CODE, -2.0, 8, seed=7)
    alpha = _params(CODE.m_b, 1, seed=8)[0]
    cfg = DecoderConfig(normalization=tuple(float(x) for x in alpha[0]), max_iters=T,
                        early_exit=False, soft_output=True)
    res = bp.decode_qc(CODE, cfg, torch.from_numpy(llr))
    assert (res.iterations == T).all()
    posts = learned.make_unrolled(CODE, T)(
        {"alpha": torch.from_numpy(alpha), "beta": torch.zeros((1, CODE.m_b))},
        torch.from_numpy(llr))
    assert torch.equal(posts[-1], res.posteriors)


# ---------------------------------------------------------------------------
# the training step and the trainer
# ---------------------------------------------------------------------------

def _ref_step(code, T, lr, train_offset, reg_to_init, init_alpha, init_beta):
    """A replica of the body of the reference's ``train_nms.step``
    (``myldpccppapi_tpu/ops/learned.py:233-256``) on given batches."""
    run = ref_learned.make_unrolled(code, T)
    opt = optax.adam(lr)

    @jax.jit
    def step(params, opt_state, llr, cw):
        def loss_fn(p):
            if not train_offset:
                p = {"alpha": p["alpha"], "beta": jax.lax.stop_gradient(p["beta"])}
            loss = ref_learned.soft_ber_loss(run(p, llr), cw)
            if reg_to_init:
                loss = loss + reg_to_init * (
                    jnp.mean(jnp.square(p["alpha"] - init_alpha))
                    + jnp.mean(jnp.square(p["beta"] - init_beta)))
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        params = {"alpha": jnp.clip(params["alpha"], 0.05, 1.0),
                  "beta": jnp.clip(params["beta"], 0.0, 2.0)}
        return params, opt_state, loss

    return opt, step


@pytest.mark.parametrize("train_offset,reg_to_init,rows", [
    (False, 0.0, 2), (True, 0.5, 1)])
def test_train_step_matches_reference_replica(train_offset, reg_to_init, rows):
    code, ref_code = SMALL["odd_z8"]
    T, lr, steps, init_alpha, init_beta = 2, 0.05, 3, 0.75, 0.1
    opt_r, step_r = _ref_step(ref_code, T, lr, train_offset, reg_to_init,
                              init_alpha, init_beta)
    p_r = {"alpha": jnp.full((rows, code.m_b), init_alpha, jnp.float32),
           "beta": jnp.full((rows, code.m_b), init_beta, jnp.float32)}
    s_r = opt_r.init(p_r)
    params = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in p_r.items()}
    opt = torch.optim.Adam([params["alpha"], params["beta"]], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    run = learned.make_unrolled(code, T)
    rng = np.random.default_rng(40)
    for i in range(steps):
        # random bits through the channel (the loss needs no codeword)
        cw = rng.integers(0, 2, size=(32, code.n)).astype(np.float32)
        sigma = np.float32(10 ** (-(1.0 + i) / 20))
        y = 1 - 2 * cw + sigma * rng.standard_normal(cw.shape).astype(np.float32)
        llr = (y * np.float32(2 / sigma**2)).astype(np.float32)
        p_r, s_r, want = step_r(p_r, s_r, jnp.asarray(llr), jnp.asarray(cw))
        got = learned.train_step(params, opt, run, torch.from_numpy(llr),
                                 torch.from_numpy(cw), train_offset=train_offset,
                                 reg_to_init=reg_to_init, init_alpha=init_alpha,
                                 init_beta=init_beta)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        for k in ("alpha", "beta"):
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(p_r[k]),
                                       rtol=0, atol=1e-5, err_msg=k)
    moved = params["beta"].detach().numpy() != init_beta
    assert moved.any() == train_offset


def test_train_nms_smoke_loss_falls():
    # from plain min-sum (alpha 1), the schedule's far end
    lw = learned.train_nms(CODE, n_iters=4, steps=24, batch=64, snr_db=(1.5, 3.0),
                           lr=0.03, seed=1, init_alpha=1.0, device="cpu")
    assert lw.alpha.shape == (4, CODE.m_b) and lw.n_iters == 4
    losses = np.asarray(lw.losses)
    assert np.isfinite(losses).all() and len(losses) == 24
    assert losses[-6:].mean() < losses[:6].mean()
    assert (lw.alpha >= 0.05).all() and (lw.alpha <= 1.0).all() and not lw.beta.any()
    # held out: the trained schedule beats the init on a fixed batch of
    # the all-zero codeword at 2 dB
    run = learned.make_unrolled(CODE, 4)
    zero = torch.zeros((128, CODE.n))
    gen = torch.Generator().manual_seed(9)
    sigma = 10 ** (-2.0 / 20)
    llr = 2 * (1 + sigma * torch.randn((128, CODE.n), generator=gen)) / sigma**2
    init = {"alpha": torch.full((4, CODE.m_b), 1.0), "beta": torch.zeros((4, CODE.m_b))}
    trained = {"alpha": torch.from_numpy(lw.alpha), "beta": torch.from_numpy(lw.beta)}
    assert (learned.soft_ber_loss(run(trained, llr), zero)
            < learned.soft_ber_loss(run(init, llr), zero))
    # random codewords through an encoder (info bits [batch, k] uint8 in)
    from myldpccppapi_torch.codes import Encoder

    lw_rand = learned.train_nms(CODE, n_iters=2, steps=2, batch=16, lr=0.03, seed=2,
                                encode_fn=Encoder(CODE, device="cpu"), device="cpu")
    assert np.isfinite(lw_rand.losses).all() and lw_rand.alpha.shape == (2, CODE.m_b)
    # the full schedule decodes on the torch path, its per-layer collapse
    # is kernel-servable
    assert bp.weights_mode(lw.decoder_config(max_iters=12), CODE.m_b) == "iter"
    assert bp.weights_mode(lw.decoder_config(per_layer=True), CODE.m_b) == "layer"


@pytest.mark.parametrize("name", ["wimax576_r12_T10", "wimax576_r34B_tied",
                                  "nr_bg2_z384_tied"])
def test_learned_weights_match_reference(name):
    alpha, beta, final = _stored(name)
    theirs = ref_learned.LearnedWeights(alpha=alpha, beta=beta, losses=(1.0, final))
    mine = interop.learned_from_reference(theirs)
    np.testing.assert_array_equal(mine.alpha, alpha)
    np.testing.assert_array_equal(mine.beta, beta)
    assert mine.losses == (1.0, final) and mine.n_iters == theirs.n_iters
    direct = learned.LearnedWeights(alpha=alpha, beta=beta, losses=(1.0, final))
    for per_layer in (False, True):
        assert mine.config_values(per_layer) == theirs.config_values(per_layer)
        assert direct.config_values(per_layer) == theirs.config_values(per_layer)
        base = dict(max_iters=9, schedule="layered")
        assert mine.decoder_config(DecoderConfig(**base), per_layer, max_iters=7) == \
            interop.config_from_reference(theirs.decoder_config(
                ref.DecoderConfig(**base), per_layer, max_iters=7))
    # a non-zero offset schedule keeps its rows
    with_beta = ref_learned.LearnedWeights(alpha=alpha, beta=beta + 0.125, losses=())
    mine_b = interop.learned_from_reference(with_beta)
    assert mine_b.config_values() == with_beta.config_values()
    assert mine_b.config_values(True) == with_beta.config_values(True)


# ---------------------------------------------------------------------------
# the kernels refuse per-iteration schedules
# ---------------------------------------------------------------------------

def test_kernels_refuse_per_iteration_schedules():
    iter_cfg = DecoderConfig(normalization=_t10(), max_iters=12)
    layer_cfg = DecoderConfig(normalization=_t10()[0])
    assert cuda_bp.supported(CODE, layer_cfg) and not cuda_bp.supported(CODE, iter_cfg)
    nr = nr_code(64, 1)
    nr_iter = DecoderConfig(normalization=((0.8,), (0.7,)))
    assert cuda_long.supported(nr, DecoderConfig(normalization=(0.8,) * nr.m_b))
    assert not cuda_long.supported(nr, nr_iter)
    assert not cuda_bp.supported(nr_code(32, 1), nr_iter)  # kernel B's route
    assert "per-iteration" in cuda_bp.REQUIREMENTS
    assert "per-iteration" in cuda_long.REQUIREMENTS
    with pytest.raises(ValueError, match="torch path"):
        bp.layer_weights(iter_cfg.normalization, 0.0, CODE.m_b)
    with pytest.raises(NotImplementedError, match="scalar"):
        check_edgelist_config(iter_cfg)
    # auto on the card takes the torch path, as the reference's takes jnp;
    # an explicit kernel still raises
    assert _implementation(CODE, iter_cfg, torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="does not serve"):
        _implementation(CODE, dataclasses.replace(iter_cfg, implementation="cuda"),
                        torch.device("cuda"))
    assert _implementation(CODE, dataclasses.replace(iter_cfg, implementation="torch"),
                           torch.device("cuda")) == "torch"
