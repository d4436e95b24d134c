"""The PyTorch port stands alone: it imports neither JAX nor any module
of the JAX package (``dstack_tpu``; the port's own name starts with the
same letters, hence ``dstack_tpu(?!_torch)``), and its default-device
entry points refuse to run without CUDA instead of falling back to the
CPU."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dstack_tpu_torch"
JAX_PACKAGE = re.compile(r"^dstack_tpu(?!_torch)(\.|$)")


def _port_modules() -> list[str]:
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_the_scan_covers_the_step_sites_and_their_accounting():
    """The modules below hold copies of JAX-package code (the flight and
    boot recorders, tracing, the SLO engine, the fault layer, QoS, the retry
    helpers, the profiler's routes, the HF tokenizer, the routing pool and
    forwarder, and the loadgen soak) beside the graph sites: the two scans
    here must reach them."""
    assert {"dstack_tpu_torch.obs.flight", "dstack_tpu_torch.obs.boot",
            "dstack_tpu_torch.serve.graphs", "dstack_tpu_torch.obs.tracing", "dstack_tpu_torch.obs.slo",
            "dstack_tpu_torch.obs.profiling", "dstack_tpu_torch.faults", "dstack_tpu_torch.faults.catalog",
            "dstack_tpu_torch.faults.__main__", "dstack_tpu_torch.qos", "dstack_tpu_torch.qos.metrics",
            "dstack_tpu_torch.utils.retry", "dstack_tpu_torch.serve.tokenizer",
            "dstack_tpu_torch.routing", "dstack_tpu_torch.routing.affinity", "dstack_tpu_torch.routing.pool",
            "dstack_tpu_torch.routing.forward", "dstack_tpu_torch.routing.metrics",
            "dstack_tpu_torch.loadgen", "dstack_tpu_torch.loadgen.soak", "dstack_tpu_torch.loadgen.driver",
            "dstack_tpu_torch.loadgen.schedule", "dstack_tpu_torch.loadgen.spec", "dstack_tpu_torch.loadgen.report",
            "dstack_tpu_torch.loadgen.metrics", "dstack_tpu_torch.loadgen.__main__",
            "dstack_tpu_torch.parallel", "dstack_tpu_torch.parallel.mesh", "dstack_tpu_torch.parallel.sharding",
            "dstack_tpu_torch.parallel.ring_attention", "dstack_tpu_torch.parallel.ulysses"} <= set(_port_modules())


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dstack_tpu' or m.startswith('dstack_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_source_scan_finds_no_jax_or_dstack_tpu_import():
    offenders = []
    for f in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name == "jax" or name.startswith("jax.") or JAX_PACKAGE.match(name):
                    offenders.append(f"{f.relative_to(REPO)}:{node.lineno} {name}")
    assert not offenders, offenders


def test_the_port_has_its_own_kernel_sources():
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {
        "flash_fwd.cu", "flash_fwd_mla.cu", "flash_decode.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu",
        "w8_matmul.cu", "adam8.cu",
    }


class TestNoSilentCpuFallback:
    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_engine_default_device_raises(self):
        from dstack_tpu_torch.models import llama
        from dstack_tpu_torch.serve.engine import InferenceEngine

        params = llama.init_params(
            llama.LLAMA_TINY_64, torch.Generator().manual_seed(0), device="cpu"
        )
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(llama.LLAMA_TINY_64, params)

    def test_server_default_device_raises(self):
        from dstack_tpu_torch.serve import openai_server

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            openai_server.main(["--model", "llama-tiny-64"])

    def test_finetune_default_device_raises(self):
        from dstack_tpu_torch.train import finetune

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            finetune.main(["--model", "llama-tiny-64", "--steps", "1"])

    def test_finetune_torchrun_rank_default_device_raises(self, monkeypatch):
        """A rank that torchrun started (its environment set) refuses to
        train on the CPU unasked, before it joins any process group."""
        from dstack_tpu_torch.parallel import mesh
        from dstack_tpu_torch.train import finetune

        for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                         MASTER_PORT="1").items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            finetune.main(["--model", "llama-tiny-64", "--steps", "1", "--sp", "2"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.make_mesh(mesh.MeshConfig(sp=2))

    def test_kernel_wrapper_raises_for_a_non_cpu_tensor(self):
        from dstack_tpu_torch.ops import flash

        x = torch.zeros(1, 2, 16, 64, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            flash.flash_attention_with_lse(x, x, x)
