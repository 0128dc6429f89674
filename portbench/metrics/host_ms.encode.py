"""The host's own serial time a request: each ``svtpu.pipeline.run_frames``
span less the union of the ``*.wait`` spans inside it (copies in and
readbacks, where the host waits on the card), averaged over the requests in
the traced window, in milliseconds."""
from portbench import spans


def read(h):
    return spans.host_ms(h)
