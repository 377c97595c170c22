"""CPU execution settings shared by the parity tests and their workers."""

import torch

# The transcendentals torch computes through the CPU library's vector math
# (a call split over the intra-op threads, each thread's share one library
# call).
_VECTOR_MATH = (torch.sin, torch.cos, torch.tan, torch.asin, torch.acos,
                torch.atan, torch.tanh, torch.exp, torch.log, torch.log2,
                torch.log10, torch.sqrt, torch.erf, torch.erfc, torch.erfinv)


def warm_up_vector_math():
    """Call each vectorized transcendental once on every intra-op thread,
    so that no later call is a thread's first.

    In a fresh process the CPU library sometimes returns a thread's first
    call of such a function at far lower accuracy when it is not the
    calling thread: in the two-rank NeRF test's worker processes (two
    threads) the second half of the first ``torch.sin`` (the
    view-direction encoding) came back up to 1.5e-4 off, about 1300 ulps,
    in about one fresh process in fourteen on a loaded host, and never in a
    later call of the process.  Call this after ``torch.set_num_threads``
    and before the computations a test compares.
    """
    x = torch.linspace(0.01, 0.99, 1 << 16)   # every thread gets a share
    for fn in _VECTOR_MATH:
        fn(x)
