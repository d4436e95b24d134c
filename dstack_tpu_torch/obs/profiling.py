"""On-demand profiler capture into a directory (counterpart of
``dstack_tpu.obs.profiling``, on ``torch.profiler``).

One guarded wrapper behind the server's ``/debug/profiler/start`` and
``/stop`` routes, with JAX's replies (``{"tracing": bool, "dir": ...}``)
and JAX's gate: the routes exist only when ``DTPU_PROFILER_DIR`` is set,
since an always-on unauthenticated knob that writes large traces would
be a production footgun.

A capture records CPU activity, and CUDA activity where CUDA is
initialised; stop writes one chrome trace, ``dtpu_trace_<n>_<pid>.json``,
into the directory, the form ``finetune --profile-dir`` writes. The
server's steps run on worker threads while start and stop run on the
event loop, and the profiler records the CPU ops of the starting thread
only unless Kineto is asked for all threads (``profile_all_threads``,
where this torch has it; the card's kernels come from CUPTI, which sees
every thread either way). torch is imported lazily.
"""

import itertools
import os
import threading
from typing import Optional

_lock = threading.Lock()
_active_dir: Optional[str] = None
_prof = None
_seq = itertools.count(1)


def profiler_dir() -> Optional[str]:
    """The configured capture directory, or None when disabled."""
    return os.environ.get("DTPU_PROFILER_DIR") or None


def start_trace(trace_dir: Optional[str] = None) -> dict:
    """Begin a capture; returns {"tracing": True, "dir": ...}.
    Raises RuntimeError when a capture is already running."""
    global _active_dir, _prof
    d = trace_dir or profiler_dir()
    if not d:
        raise RuntimeError("profiler disabled (set DTPU_PROFILER_DIR)")
    import torch

    with _lock:
        if _active_dir is not None:
            raise RuntimeError(f"trace already running into {_active_dir}")
        os.makedirs(d, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities, experimental_config=_all_threads(torch))
        prof.start()
        _prof, _active_dir = prof, d
    return {"tracing": True, "dir": d}


def _all_threads(torch):
    """Kineto's config that records every thread's CPU ops, or None where
    this torch predates the option."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def stop_trace() -> dict:
    """End the capture and write its chrome trace; returns
    {"tracing": False, "dir": ...}. Raises RuntimeError when no capture
    is running."""
    global _active_dir, _prof
    with _lock:
        if _active_dir is None:
            raise RuntimeError("no trace running")
        d, prof = _active_dir, _prof
        _prof, _active_dir = None, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(d, f"dtpu_trace_{next(_seq)}_{os.getpid()}.json"))
    return {"tracing": False, "dir": d}


def is_tracing() -> bool:
    return _active_dir is not None
