"""The share of kernel A's launches (``csrc/bp_layered.cu``) that ran its
fitted instantiation, five edge slots a lane, in %: the program's counters
``decode_qc_cuda.fitted_launches`` over ``decode_qc_cuda.launches``
(``ops/cuda_bp.py``), each summed over every launch of the process (in a
receive run: the warm-up's, the window's and the traced slice's).  None
where the program has no fitted counter or counted no launch."""


def read(ctx):
    from myldpccppapi_torch.ops import cuda_bp

    decode = cuda_bp.decode_qc_cuda
    fitted = getattr(decode, "fitted_launches", None)
    launches = getattr(decode, "launches", 0)
    if fitted is None or not launches:
        return None
    return 100.0 * fitted / launches
