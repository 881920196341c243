"""Device kernels a fit step: the most common count of a traced chain's
kernels (CUPTI can drop a record), over its steps."""

from perfbench.trace import is_kernel, mode


def read(st):
    if st.kind != "fit" or not st.units:
        return None
    n = mode([sum(is_kernel(x) for _, _, x in st.unit_ops(u))
              for u in range(len(st.units))])
    return n / st.steps_per_unit
