"""Host ms of each ``api.render`` call (copy-in, graph launch, clone),
from the benchmark's own span around it: the mean over the measured
window's frames, which run before the traced stretch (once the profiler
has attached CUPTI, a graph launch takes 2.5-6 times as long on the
host)."""


def read(st):
    spans = st.host.get("dispatch")
    return 1e3 * sum(spans) / len(spans) if spans else None
