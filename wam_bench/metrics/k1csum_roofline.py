"""k1csum_roofline: share (%) of its roofline that kernel k1csum reached in
the traced window: the bound of every launch (``kernels/k1csum.json``,
bytes over the memory bandwidth or f32 operations over the f32 peak,
the larger) over the kernel's device time in the trace."""

from wam_bench import stats


def read(rec):
    return stats.kernel_roofline("k1csum", rec)
