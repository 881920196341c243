"""Device kernels a frame: the most common count over the traced frames
(CUPTI can drop a record)."""

from perfbench.trace import is_kernel, mode


def read(st):
    if st.kind != "render" or not st.units:
        return None
    return float(mode([sum(is_kernel(n) for _, _, n in st.unit_ops(u))
                       for u in range(len(st.units))]))
