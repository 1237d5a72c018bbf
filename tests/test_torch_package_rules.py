"""Rules of the port that hold without a card.

- marian_tpu_torch/, chip_smoke.py and scripts/torch_decode_profile.py
  import neither jax nor anything of marian_tpu (AST scan);
- the entry points run on CUDA unless the CPU is asked for, and raise
  without a card instead of falling back to the CPU;
- a kernel wrapper given a CUDA tensor launches its kernel or raises; it
  never runs its plain version.
"""

import ast
from pathlib import Path

import pytest
import torch

from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.device import resolve_device
from marian_tpu_torch.ops import attention as tatt
from marian_tpu_torch.ops.kernels import decode_attention as dmod
from marian_tpu_torch.ops.kernels import packed_attention as pmod
from marian_tpu_torch.translator.translator import Translate

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "marian_tpu")


def _port_files():
    files = sorted((ROOT / "marian_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "scripts" / "torch_decode_profile.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_marian_tpu():
    files = _port_files()
    assert len(files) > 10 and all(p.exists() for p in files)
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_resolution(no_card):
    with pytest.raises(RuntimeError, match="--cpu-threads"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(cpu_threads=2) == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_decoder_entry_point_raises_without_card(no_card, tmp_path):
    opts = parse_options(["--models", str(tmp_path / "absent.npz"),
                          "--vocabs", "a.yml", "b.yml"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Translate(opts)
    with pytest.raises(SystemExit):
        parse_options(["--models", "m.npz", "--no-such-flag"])


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def _cuda_typed(*shape):
    return torch.randn(*shape).as_subclass(_CudaTyped)


@pytest.fixture
def plain_forbidden(monkeypatch):
    def fail(*a, **k):
        pytest.fail("a kernel wrapper ran its plain version on a CUDA tensor")
    monkeypatch.setattr(dmod, "decode_attention_reference", fail)
    monkeypatch.setattr(pmod, "packed_attention_reference", fail)


def test_decode_attention_wrapper_raises_on_cuda_request(plain_forbidden):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel would run")
    before = dmod.decode_attention.launches
    q = _cuda_typed(4, 2, 1, 8)
    with pytest.raises(RuntimeError):
        dmod.decode_attention(q, _cuda_typed(4, 2, 1, 8),
                              _cuda_typed(4, 2, 1, 8),
                              _cuda_typed(4, 2, 6, 8),
                              _cuda_typed(4, 2, 6, 8), 3)
    assert dmod.decode_attention.launches == before


def test_packed_attention_wrapper_raises_on_cuda_request(plain_forbidden):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel would run")
    before = pmod.packed_attention.launches
    q = _cuda_typed(2, 2, 5, 8)
    with pytest.raises(RuntimeError):
        pmod.packed_attention(q, _cuda_typed(2, 2, 5, 8),
                              _cuda_typed(2, 2, 5, 8))
    # the dispatcher's 'auto' engages the kernel for a CUDA tensor too
    with pytest.raises(RuntimeError):
        tatt.attention(q, _cuda_typed(2, 2, 5, 8), _cuda_typed(2, 2, 5, 8),
                       kv_mask=torch.ones(2, 5))
    assert pmod.packed_attention.launches == before


def test_packed_attention_refuses_grad_on_cuda():
    q = _cuda_typed(1, 1, 3, 8).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        pmod.packed_attention(q, _cuda_typed(1, 1, 3, 8),
                              _cuda_typed(1, 1, 3, 8))
