"""The image encoder's part of a request (the ``svtpu.sam2.encode`` spans:
the enqueue of the copy, resize and normalisation, and of the encoder's
graph, up to its features on the card) in the traced window, over the
requests (``svtpu.pipeline.run_frames`` spans) in it, in milliseconds.
Nothing to read where the window holds no such span (a program without
the image encoder)."""
from portbench import spans

SPAN = "svtpu.sam2.encode"


def read(h):
    if not any(n == SPAN for _, _, n in spans.program_spans(h) or ()):
        return None
    return spans.per_request_ms(h, SPAN)
