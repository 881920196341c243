"""Device ms a frame of every kernel but the intersection kernels (B1,
B2, the pair route's): the integrator's and shading's own kernels, the
mean over the traced frames."""

from perfbench import program
from perfbench.trace import is_kernel


def read(st):
    if st.kind != "render" or not st.units:
        return None
    per = [sum(e - s for s, e, n in st.unit_ops(u)
               if is_kernel(n) and program.route_of(n) is None)
           for u in range(len(st.units))]
    return 1e-3 * sum(per) / len(per)
