"""Warmup-coverage manifest helpers (own copy of ``manifest_key`` and
``manifest_diff`` from ``dstack_tpu.obs.boot``; the boot recorder's
stages, ``/debug/boot`` and the fleet registry come with ROADMAP A4).
The engine holds the manifest; these are pure helpers."""

from typing import Any


def manifest_key(fn_name: str, key: Any = None) -> str:
    """One canonical string per (site, bucket key) compile variant, the
    unit of warmup coverage. Keys are stringified with ``repr``, as the
    flight ring stringifies them, so the manifest and the steady-state
    detector never disagree on identity."""
    return fn_name if key is None else f"{fn_name}{key!r}"


def manifest_diff(manifest, observed) -> dict:
    """A warmup manifest against steady-state compile keys →
    ``{"covered": [...], "gaps": [...]}``: ``gaps`` are variants steady
    traffic compiled that warmup never visited; ``covered`` the observed
    ones warmup did pre-pay."""
    mset = set(manifest)
    oset = set(observed)
    return {"covered": sorted(oset & mset), "gaps": sorted(oset - mset)}
