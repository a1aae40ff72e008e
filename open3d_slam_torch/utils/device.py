"""Device selection, the device record, and counted device->host pulls.

Every blocking device->host transfer on the main path goes through
``to_host``, which counts it: on the card each one is a synchronisation
that stalls the host until the queued kernels have drained, so the count
per scan is a metric of its own (the JAX package keeps it to one pull per
scan plus the Gauss-Newton loop, which ``lax.while_loop`` keeps on device).
Each pull is also a ``pull`` span of ``utils.timeutil.telemetry`` and a
``pulls`` count of the span it is made in, so a recording places every
pull by site.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import torch

from open3d_slam_torch.utils.timeutil import telemetry


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when the
    requested device is CUDA and no GPU is present (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def nvcc_path() -> Optional[str]:
    """Path of ``nvcc``: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def nvidia_smi_name_power() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_record() -> dict:
    """Name, power limit, CUDA version and nvcc path of this machine's card."""
    rec = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cuda_available": torch.cuda.is_available(),
           "nvcc": nvcc_path(), "name_power_limit": nvidia_smi_name_power()}
    if torch.cuda.is_available():
        rec["name"] = torch.cuda.get_device_name(0)
        rec["count"] = torch.cuda.device_count()
    return rec


class HostSyncCounter:
    """Number of blocking device->host pulls made through ``to_host``."""

    def __init__(self):
        self.count = 0


host_syncs = HostSyncCounter()


class Prefetched:
    """Device tensors whose copy to the host was started without waiting
    (``prefetch_to_host``): pinned host buffers filled by ``non_blocking``
    copies, and a CUDA event recorded after them.  Pass it to ``to_host`` to
    read the values; that pull waits for the event only, not for work queued
    later on the stream.  On the CPU it just holds the tensors."""

    def __init__(self, tensors):
        self.shapes = [tuple(t.shape) for t in tensors]
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t.detach(), non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.detach() for t in tensors]

    def ready(self) -> bool:
        """True once the copies have landed (a pull then costs nothing)."""
        return self.event is None or self.event.query()


def prefetch_to_host(*tensors) -> Prefetched:
    """Start the device->host copy of ``tensors`` now; read them later with
    ``to_host(prefetched)``."""
    return Prefetched([t for t in tensors if t is not None])


def to_host(*tensors):
    """ONE counted blocking pull of ``tensors`` -> tuple of numpy arrays.
    A ``Prefetched`` argument stands for its tensors, in order; it is read
    from its host buffers once its event has completed."""
    host_syncs.count += 1
    telemetry.count("pulls")
    if not tensors:
        return ()
    with telemetry.pull():
        live = [t for t in tensors if not isinstance(t, Prefetched)]
        flat = (torch.cat([t.detach().reshape(-1).to(torch.float64)
                           for t in live]).cpu().numpy() if live else None)
        out, off = [], 0
        for t in tensors:
            if isinstance(t, Prefetched):
                if t.event is not None:
                    t.event.synchronize()
                out.extend(h.to(torch.float64).numpy().reshape(s)
                           for h, s in zip(t.host, t.shapes))
                continue
            n = t.numel()
            out.append(flat[off:off + n].reshape(tuple(t.shape)))
            off += n
        return tuple(out)


def to_device(a, device, dtype=torch.float32) -> torch.Tensor:
    """Host array -> tensor on ``device`` WITHOUT a host sync: a plain
    ``.to('cuda')`` of pageable memory waits for every queued kernel, so on
    the card the data goes through pinned memory with a non-blocking copy."""
    t = torch.as_tensor(a, dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pull_bool(t: torch.Tensor) -> bool:
    """Counted pull of a one-element boolean tensor."""
    return bool(to_host(t)[0].reshape(-1)[0])
