"""The port's torch layered decode held against the JAX package's native
C++ layered golden (``myldpccppapi_tpu.native.decode_golden_layered_native``,
built from its sources with g++ on first use), an implementation
independent of both packages' tensor code: bits, convergence and
iterations equal, bit for bit in f32, at wimax 576 r3/4B."""
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu import native

from myldpccppapi_torch.codes import encode_numpy, ru_precompute, wimax
from myldpccppapi_torch.ops.bp import decode_layered
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

CODE = wimax(576, "3/4B")
REF_CODE = ref.wimax(576, "3/4B")


def _llr(snr_db, batch, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, CODE.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(CODE), u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


@pytest.mark.parametrize("snr_db,alpha,beta,max_iters", [
    (5.0, 0.75, 0.0, 40), (3.0, 0.75, 0.0, 40), (4.0, 1.0, 0.0, 20),
    (4.0, 1.0, 0.5, 30), (3.5, 0.8, 0.25, 12)])
def test_torch_layered_equals_native_golden(snr_db, alpha, beta, max_iters):
    llr = _llr(snr_db, 256, seed=int(10 * snr_db) + max_iters)
    golden = native.decode_golden_layered_native(REF_CODE, llr, max_iters=max_iters,
                                                 normalization=alpha, offset=beta)
    assert golden is not None, "the native golden library did not build"
    bits, conv, iters = golden
    got = decode_layered(CODE, DecoderConfig(normalization=alpha, offset=beta,
                                             max_iters=max_iters),
                         torch.from_numpy(llr))
    assert 0 < conv.sum() <= len(conv)
    np.testing.assert_array_equal(got.bits.numpy(), bits)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    np.testing.assert_array_equal(got.iterations.numpy(), iters)
