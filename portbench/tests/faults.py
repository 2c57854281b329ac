"""Faults planted under the timed path, for the tests: each wraps the
program's ``Decoder`` (``wrap_decoder``), and a run over it must come out
not correct."""
import torch


def unchanged(dec):
    """A decode that returns its state unchanged: the channel's hard
    decisions, no sweep, nothing converged."""
    def call(llr):
        res = dec(llr)
        return res._replace(bits=(llr <= 0).to(torch.uint8),
                            converged=torch.zeros_like(res.converged),
                            iterations=torch.zeros_like(res.iterations))
    return call


def half_batch(dec):
    """Half of the batch left out: the first half decoded, its answers
    handed out for the rest too."""
    def call(llr):
        res = dec(llr[:llr.shape[0] // 2])
        return res._replace(bits=torch.cat([res.bits, res.bits]),
                            converged=torch.cat([res.converged, res.converged]),
                            iterations=torch.cat([res.iterations, res.iterations]))
    return call


def altered(dec):
    """One answer altered where it is produced: frame 0's first
    information bit flipped."""
    def call(llr):
        res = dec(llr)
        bits = res.bits.clone()
        bits[0, 0] ^= 1
        return res._replace(bits=bits)
    return call

