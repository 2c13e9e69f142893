"""Which JAX backend a run uses, and which card a process takes.

The program runs on an NVIDIA GPU. A run on the CPU has to be asked for with
``JAX_PLATFORMS=cpu`` (the tests and CI do so): ``ensure_backend()`` refuses
to fall back to the CPU on its own, so a CPU run is never taken for a GPU one.
"""

from __future__ import annotations

import glob
import os
import subprocess


def ensure_backend(require_gpu: bool = False) -> str:
    """Start JAX's backend and return its platform name.

    Raises RuntimeError when no GPU is found, unless the CPU was pinned with
    JAX_PLATFORMS=cpu; with ``require_gpu`` (benchmarks, the chip smoke
    test) a pinned CPU is refused too."""
    import jax

    pinned = [
        p.strip() for p in (jax.config.jax_platforms or "").split(",") if p.strip()
    ]
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        raise RuntimeError(
            f"JAX could not start a backend (JAX_PLATFORMS={','.join(pinned)!r}): {e}"
        ) from e
    if dev.platform == "gpu":
        return dev.platform
    if require_gpu:
        raise RuntimeError(
            f"this command needs an NVIDIA GPU, but JAX runs on "
            f"{dev.platform} ({dev.device_kind})"
        )
    if dev.platform == "cpu" and pinned != ["cpu"]:
        raise RuntimeError(
            "no GPU found, and JAX would fall back to the CPU; set "
            "JAX_PLATFORMS=cpu to run on the CPU on purpose"
        )
    return dev.platform


def local_gpu_count() -> int:
    """NVIDIA cards this host exposes to the process, counted without
    starting JAX (CUDA_VISIBLE_DEVICES when set, else /dev/nvidiaN)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([v for v in vis.split(",") if v.strip()])
    return len(glob.glob("/dev/nvidia[0-9]*"))


def pin_local_card(process_id: int) -> int | None:
    """Let this process see only its own local card, ``process_id % count``.

    Must run before JAX's backend starts: otherwise every rank on a host
    opens card 0 and reserves most of its memory. Returns the card index, or
    None when the host has no NVIDIA card (or the CPU is pinned)."""
    import jax

    n = local_gpu_count()
    if n == 0 or (jax.config.jax_platforms or "").strip() == "cpu":
        return None
    card = process_id % n
    jax.config.update("jax_cuda_visible_devices", str(card))
    return card


def device_memory_mb() -> int:
    """MiB that JAX may allocate on device 0 (``memory_stats()["bytes_limit"]``).
    A backend without memory stats (the CPU) allocates from host memory, so
    there it is the host's physical memory."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return int(limit) >> 20
    return (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")) >> 20


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output (one line per card), or None where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
            check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
