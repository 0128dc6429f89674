"""The ``copy_chunks.encode`` reader on synthetic traces: the host-to-card
copies a request over the window, whatever the drift of the device's clock,
and nothing to read without requests or without copies."""
import pytest

from portbench import tracing

from test_portbench_tracing import ev, read, trace

W = tracing.WINDOW_SPAN
SPAN = "user_annotation"
REQUEST = "svtpu.pipeline.run_frames"
PINNED = "Memcpy HtoD (Pinned -> Device)"


def requests(starts, chunks, dur=100, copy=PINNED, drift=0):
    """A request of ``dur`` us at each start, ``chunks`` host-to-card
    copies of 5 us inside each (on a device clock ``drift`` us ahead of
    the host's), and its readback."""
    out = []
    for s in starts:
        out.append(ev(REQUEST, SPAN, s, dur))
        out += [ev(copy, "gpu_memcpy", s + 10 + 10 * k + drift, 5)
                for k in range(chunks)]
        out.append(ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                      s + dur - 6, 5))
    return out


@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_copies_a_request(tmp_path, k):
    """Three requests in the window [1000, 2000) read k; copies outside
    it, card-to-card copies and kernels are not counted."""
    s = trace(tmp_path, [ev(W, SPAN, 1000, 1000)]
              + requests([700, 1100, 1400, 1700, 2100], k, dur=200)
              + [ev("svtpu.pipeline.copy_in", SPAN, 1105, 90),
                 ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1290, 3),
                 ev("at::native::upsample_gen2d_aa_out_frame", "kernel",
                    1420, 40)])
    assert read("copy_chunks.encode", s) == pytest.approx(k)


@pytest.mark.parametrize("drift", [-15, 30])
def test_a_drifting_device_clock(tmp_path, drift):
    """Copies that the device's clock places before their request's start
    or after its end still count, one request with another."""
    s = trace(tmp_path, [ev(W, SPAN, 0, 1000)]
              + requests([100, 200, 300, 400], 8, dur=95, drift=drift))
    assert read("copy_chunks.encode", s) == pytest.approx(8)


def test_pageable_copies_and_requests_copied_whole(tmp_path):
    """Two requests of 8 pageable copies and two of one average 4.5."""
    s = trace(tmp_path, [ev(W, SPAN, 0, 1000)]
              + requests([100, 300], 8, copy="Memcpy HtoD (Pageable -> "
                         "Device)") + requests([500, 700], 1))
    assert read("copy_chunks.encode", s) == pytest.approx(4.5)


@pytest.mark.parametrize("events", [
    # Copies in the window, but no request span around them.
    [ev("portbench.request", SPAN, 100, 400),
     ev(PINNED, "gpu_memcpy", 120, 50), ev("k", "kernel", 200, 50)],
    # Requests, and no copy to the card inside them.
    requests([100, 300], 0),
], ids=["no-request-span", "no-copy"])
def test_nothing_to_read(tmp_path, events):
    s = trace(tmp_path, [ev(W, SPAN, 0, 1000)] + events)
    assert read("copy_chunks.encode", s) is None
