"""The port's boundary: ``rmqtt_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package, and its entry points never fall back
to the CPU on their own."""

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "rmqtt_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        yield ".".join(p for p in rel.parts if p != "__init__")


def test_imports_without_jax_or_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, sys
        sys.modules["jax"] = None
        sys.modules["rmqtt_tpu"] = None
        sys.path.insert(0, {str(ROOT)!r})
        for name in {list(_modules())!r}:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "rmqtt_tpu" or m.startswith("rmqtt_tpu."))
        assert all(sys.modules[m] is None for m in bad), bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_source_imports_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|rmqtt_tpu(\.|\s|$))", re.M)
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_no_device_means_cuda_or_raise():
    from rmqtt_tpu_torch.router import TorchRouter

    if torch.cuda.is_available():
        assert TorchRouter().matcher.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchRouter()
    assert TorchRouter(device="cpu").matcher.device.type == "cpu"


def test_cuda_wrapper_never_falls_back():
    """A non-CPU tensor the kernel cannot take raises instead of running
    the plain twin."""
    from rmqtt_tpu_torch.ops import match_words as MW
    from rmqtt_tpu_torch.ops.encode import PackedLayout

    meta = torch.empty((2, 256), dtype=torch.int32, device="meta")
    args = [torch.empty(s, dtype=torch.int32, device="meta")
            for s in ((3, 1), (3,), (3,), (3, 2))]
    with pytest.raises(ValueError, match="unsupported device"):
        MW.match_words_packed(meta, *args, layout=PackedLayout((1,)))
    assert MW.match_words_packed.launches == 0
