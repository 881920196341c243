"""Device busy ms a fit step: the union of the device ops' intervals in
the traced chains over their steps."""

from perfbench.trace import union_us


def read(st):
    if st.kind != "fit" or not st.units:
        return None
    busy = sum(union_us(st.unit_ops(u)) for u in range(len(st.units)))
    return 1e-3 * busy / (len(st.units) * st.steps_per_unit)
