"""ops.domain_pop -> csrc/domain_pop.cu: the least time the launches of the
profiled call could take (pop_count: the larger of bytes over the HBM rate
and operations over the float32 peak, counted from each launch's shapes)
over the kernel's time in the capture, in %. Nothing when the call made no
launch."""

from .pop_count import bound_s

KERNEL = "domain_pop_kernel"


def read(r):
    p = r.profile
    if p is None or not p.launches:
        return None
    kernel_ns = sum(d for name, _, d in p.events if KERNEL in name)
    if kernel_ns <= 0:
        return None
    return 100.0 * sum(bound_s(x)[0] for x in p.launches) / (kernel_ns / 1e9)
