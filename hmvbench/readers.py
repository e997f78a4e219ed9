"""The per-layer readers' arithmetic. Each ``metrics/<name>.py`` binds its
``read`` to one of these, so that a metric read alike in serving and in
training is written once; what one unit of the cell's traffic runs (a frame,
an optimizer step) comes from its traffic kind: ``k1_calls(run)``,
``stem_images(run)`` and ``flops(run)``. A reader that finds nothing to
read returns None, and the metric is left out of the result's line."""

from __future__ import annotations

from hmvbench import counts, harness

K1_KERNELS = ("attention_fwd_", "attention_tiles_")  # both of K1's designs, forward only
K2_KERNELS = ("stem_conv_",)


def _kind(run):
    return harness.traffic_kind(run.cell.traffic["kind"])


def idle_share(run):
    """The share of the device-only traced slice that no kernel, copy or set
    covers: 100 (1 - the union of the device's intervals over the slice's
    length). CUPTI's work at each launch slows the host in the slice, so a
    host-paced cell reads higher here than its untraced window would."""
    s = run.summary
    if not s.device:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu(run):
    """The whole unit's share of the chip's peak for the work's precision:
    its operations, counted on the frozen reference, times the window's
    units a second, over the peak."""
    rate = run.window["units"] / run.window["seconds"]
    return 100.0 * _kind(run).flops(run) * rate / counts.PEAKS["flops_per_s"][run.precision]


def _roofline(run, kernels, bound_s: float) -> float | None:
    """``bound_s``, the least time of a unit's calls, times the traced
    units, over the device time of ``kernels``."""
    seconds, launches = run.summary.kernel_s(*kernels)
    if not launches:
        return None
    return 100.0 * bound_s * run.summary.units / seconds


def k1_roofline(run):
    """K1's share of its roofline: a unit's forward calls of the fusion's
    attention core, operations and bytes from their shapes. Its backward is
    PyTorch ops and is not counted."""
    flops, nbytes = counts.k1_work(_kind(run).k1_calls(run), run.precision)
    return _roofline(run, K1_KERNELS, counts.bound_s(flops, nbytes, run.precision))


def k2_roofline(run):
    """K2's share of its roofline: a unit's forward stem convs, each bound
    on its own images. Its backward is ``torch.nn.grad`` and is not counted."""
    size = run.cell.config["data"]["image_size"]
    bound = sum(counts.bound_s(*counts.k2_work(n, size, run.precision), run.precision)
                for n in _kind(run).stem_images(run))
    return _roofline(run, K2_KERNELS, bound)


def range_device_ms(name: str):
    """A reader of the device milliseconds a unit of the kernels launched
    inside the benchmark's range ``hmvbench::<name>`` (module or optimizer
    hooks, in the slice traced with the host's calls)."""
    def read(run):
        seconds = run.host_summary.in_range_s(name)
        return 1e3 * seconds / run.host_summary.units if seconds else None
    return read


def peak_mem_gb(run):
    """The peak of allocated device memory over the window, in GB (1e9
    bytes), from ``torch.cuda.max_memory_allocated`` after a reset at its
    start."""
    peak = run.window.get("peak_bytes", 0)
    return peak / 1e9 if peak else None


def mesh_host_ms(run):
    """Host milliseconds a frame in the mesh stage's call, on the host's
    clock around the call in the window: its launches, since the host does
    not wait there."""
    seconds = run.window.get("mesh_host_s")
    return 1e3 * seconds / run.window["units"] if seconds else None
