"""Where a bench number came from: one label for every artifact of the
port (the counterpart of ``dstack_tpu.utils.backend.backend_info``).

``backend_info(device)`` → ``{"backend": "cuda", "device": <card name>,
"power_limit": <as nvidia-smi gives it>, "note": None}`` on the card, or
``{"backend": "cpu", "note": "CPU smoke run, not a card number"}``: a
CPU number never passes for a card's. The card's name and power limit
are read as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them (a card below its 700 W maximum runs
slower under load); without ``nvidia-smi`` they come from torch and read
``"not measured"``.
"""

import subprocess

CPU_NOTE = "CPU smoke run, not a card number"


def _nvidia_smi(index: int):
    """(name, power limit) of card ``index`` as nvidia-smi prints them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    name, _, limit = out.partition(",")
    return (name.strip(), limit.strip()) if limit else None


def backend_info(device="cuda") -> dict:
    """The label of a run on ``device`` (a ``torch.device`` or its name)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"backend": "cpu", "note": CPU_NOTE}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = _nvidia_smi(index)
    name, limit = smi or (torch.cuda.get_device_name(index), "not measured")
    return {"backend": "cuda", "device": name, "power_limit": limit, "note": None}
