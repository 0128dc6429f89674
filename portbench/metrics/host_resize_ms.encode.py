"""The host resize of a request's frames (the
``svtpu.pipeline.resize_host`` spans) in the traced window, over the
requests (``svtpu.pipeline.run_frames`` spans) in it, in milliseconds."""
from portbench import spans


def read(h):
    return spans.per_request_ms(h, "svtpu.pipeline.resize_host")
