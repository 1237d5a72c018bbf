"""Rules of the port that hold without a card.

- marian_tpu_torch/ (every subpackage: layers/, optimizers/, training/
  included), chip_smoke.py and the port's scripts (``scripts/torch_*.py``,
  the chaos harness among them) import neither
  jax nor anything of marian_tpu (AST scan), and every CUDA source the
  build lists exists and includes only CUDA and C headers (a plain C
  interface: no PyTorch, Python or XLA headers);
- the entry points run on CUDA unless the CPU is asked for, and raise
  without a card instead of falling back to the CPU;
- a kernel wrapper given a CUDA tensor launches its kernel or raises; it
  never runs its plain version (the paged decode wrapper neither: its
  in-place insert may run, its read is the kernel), and on the card the
  loss takes the fused CE kernels at every hidden size;
- the attention dispatcher takes flash attention where the reference
  does (``on``, or ``auto`` at length >= 1024) and never with ``off``;
  ``decode_attention`` has no cache-length gate; ``--attention-kernel``
  maps onto ``--transformer-flash-attention`` as in the reference, and
  the trainer refuses ``--auto-tune`` by name.
"""

import ast
from pathlib import Path

import pytest
import torch

from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.device import resolve_device
from marian_tpu_torch.models import encoder_decoder as emod
from marian_tpu_torch.models import transformer as tmod
from marian_tpu_torch.ops import attention as tatt
from marian_tpu_torch.ops.kernels import _build
from marian_tpu_torch.ops.kernels import decode_attention as dmod
from marian_tpu_torch.ops.kernels import flash_attention as famod
from marian_tpu_torch.ops.kernels import fused_ce as fmod
from marian_tpu_torch.ops.kernels import kv_pool as kvmod
from marian_tpu_torch.ops.kernels import packed_attention as pmod
from marian_tpu_torch.training.train import _refuse_unported
from marian_tpu_torch.translator.translator import Translate

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "marian_tpu")


def _port_files():
    """The package, chip_smoke.py and every script of the port
    (``scripts/torch_*.py``, later ones too)."""
    files = sorted((ROOT / "marian_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    *sorted((ROOT / "scripts").glob("torch_*.py"))]


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
    scanned = {p.relative_to(ROOT / "marian_tpu_torch").parts[0]
               for p in files if "marian_tpu_torch" in p.parts}
    assert {"layers", "optimizers", "training", "data", "models", "ops",
            "cli"} <= scanned
    # the port's copies of reference modules are scanned like the rest
    copies = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"marian_tpu_torch/common/config_validator.py",
            "marian_tpu_torch/common/signal_handling.py",
            "marian_tpu_torch/translator/metrics.py",
            "marian_tpu_torch/training/validators.py",
            "marian_tpu_torch/translator/validators.py",
            "marian_tpu_torch/training/bundle.py",
            "marian_tpu_torch/serving/metrics.py",
            "marian_tpu_torch/serving/lifecycle/__init__.py",
            "marian_tpu_torch/serving/lifecycle/registry.py",
            "marian_tpu_torch/serving/lifecycle/watcher.py",
            "marian_tpu_torch/serving/lifecycle/warmup.py",
            "marian_tpu_torch/serving/lifecycle/controller.py",
            "marian_tpu_torch/common/aliases.py",
            "marian_tpu_torch/training/batch_fit.py",
            "scripts/torch_chaos.py", "scripts/torch_train_profile.py",
            "scripts/torch_flash_bwd_ab.py"} <= copies


def test_cuda_sources_are_listed_and_plain_c():
    listed = {f"{n}.cu" for n in _build.SOURCES}
    on_disk = {p.name for p in _build.CSRC.glob("*.cu")}
    assert listed == on_disk and {"packed_attention.cu", "fused_ce.cu",
                                  "decode_attention.cu",
                                  "flash_attention.cu",
                                  "paged_decode_attention.cu"} <= listed
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    for name in sorted(listed | headers):
        text = (_build.CSRC / name).read_text(encoding="utf-8")
        includes = [l.split()[1] for l in text.splitlines()
                    if l.startswith("#include")]
        # CUDA's and the C math headers, or the package's own shared
        # headers (held to the same rule in this loop)
        assert includes and all(i.strip("<>\"").startswith(
            ("cuda", "math")) or (name.endswith(".cu") and i.strip('"')
                                  in headers)
            for i in includes), (name, includes)
        assert name in headers or "extern \"C\"" in text


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


def test_paged_decode_attention_wrapper_raises_on_cuda_request(monkeypatch):
    """On a CUDA tensor the paged wrapper launches the kernel (which
    cannot load here) or raises; its plain read never runs and no launch
    is counted."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel would run")
    monkeypatch.setattr(kvmod, "paged_decode_attention_reference",
                        lambda *a, **k: pytest.fail(
                            "the paged wrapper ran its plain read on a CUDA "
                            "tensor"))
    before = kvmod.paged_decode_attention.launches
    r, h, dh, page_len, mp = 3, 2, 8, 4, 2
    table = torch.arange(1, 1 + r * mp, dtype=torch.int32).reshape(r, mp)
    pos = torch.tensor([0, 5, -1], dtype=torch.int32)
    args = [_cuda_typed(r, h, 1, dh) for _ in range(3)] + [
        _cuda_typed(1 + r * mp, h, page_len, dh) for _ in range(2)]
    with pytest.raises(RuntimeError, match="nvcc|CUDA"):
        kvmod.paged_decode_attention(*args, table.as_subclass(_CudaTyped),
                                     pos.as_subclass(_CudaTyped))
    with pytest.raises(RuntimeError, match="nvcc|CUDA"):
        kvmod.paged_decode_attention_read(
            args[0], args[3], args[4], table.as_subclass(_CudaTyped),
            pos.as_subclass(_CudaTyped))
    assert kvmod.paged_decode_attention.launches == before


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


def test_packed_attention_refuses_grad_on_cuda(plain_forbidden,
                                              monkeypatch):
    """A CUDA q that requires grad goes through the autograd Function,
    whose forward is the kernel: without a card the launch raises, and
    neither direction falls back to its plain version."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel would run")
    monkeypatch.setattr(pmod, "packed_attention_bwd_reference",
                        lambda *a, **k: pytest.fail("plain backward ran"))
    q = _cuda_typed(1, 1, 3, 8).requires_grad_(True)
    before = (pmod.packed_attention.launches,
              pmod.packed_attention_bwd.launches)
    with pytest.raises(RuntimeError):
        pmod.packed_attention(q, _cuda_typed(1, 1, 3, 8),
                              _cuda_typed(1, 1, 3, 8))
    # the backward kernel is built for Dh 16, 32, 64 and 128: it raises
    # at a head size it does not take, and at one it takes the launch
    # raises (no card here)
    with pytest.raises(ValueError, match="head size 8"):
        pmod.packed_attention_bwd(
            _cuda_typed(1, 1, 3, 8), _cuda_typed(1, 1, 3, 8),
            _cuda_typed(1, 1, 3, 8), None, _cuda_typed(1, 1, 3, 8),
            _cuda_typed(1, 1, 3, 8))
    with pytest.raises(RuntimeError):
        pmod.packed_attention_bwd(
            _cuda_typed(1, 1, 3, 16), _cuda_typed(1, 1, 3, 16),
            _cuda_typed(1, 1, 3, 16), None, _cuda_typed(1, 1, 3, 16),
            _cuda_typed(1, 1, 3, 16))
    assert (pmod.packed_attention.launches,
            pmod.packed_attention_bwd.launches) == before


def test_fused_ce_wrappers_raise_on_cuda_request(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel would run")
    for name in ("fused_ce_stats_reference", "fused_ce_bwd_reference"):
        monkeypatch.setattr(fmod, name, lambda *a, **k: pytest.fail(
            "a fused_ce wrapper ran its plain version on a CUDA tensor"))
    x, w, b = _cuda_typed(5, 8), _cuda_typed(7, 8), _cuda_typed(7)
    labels = torch.zeros(5, dtype=torch.long)
    stats = [_cuda_typed(5) for _ in range(4)]
    before = (fmod.fused_ce_stats.launches, fmod.fused_ce_dx.launches,
              fmod.fused_ce_dw.launches)
    with pytest.raises(RuntimeError):
        fmod.fused_ce_stats(x, w, b, labels)
    with pytest.raises(RuntimeError):
        fmod.fused_ce_dx(x, w, b, labels, *stats)
    with pytest.raises(RuntimeError):
        fmod.fused_ce_dw(x, w, b, labels, *stats)
    with pytest.raises(RuntimeError):
        fmod.fused_ce_bwd(x, w, b, labels, *stats)
    assert (fmod.fused_ce_stats.launches, fmod.fused_ce_dx.launches,
            fmod.fused_ce_dw.launches) == before


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_fused_ce_engages_on_card_at_every_width(mode):
    """At transformer-big's E = 1024 the loss on a CUDA device takes the
    fused CE's output table (the kernels), never the dense logits; on the
    CPU ``auto`` stays dense, as the reference's does off the TPU."""
    opts = Options({"type": "transformer", "dim-emb": 1024,
                    "transformer-heads": 4, "transformer-dim-ffn": 64,
                    "enc-depth": 1, "dec-depth": 1,
                    "tied-embeddings-all": True, "fused-ce": mode})
    model = emod.create_model(opts, 11, 11)
    cparams = tmod.cast_params(tmod.init_params(model.cfg, 3),
                               model.cfg.compute_dtype)
    table = model._fused_ce_table(cparams, torch.device("cuda"))
    assert table is not None and tuple(table.shape) == (11, 1024)
    on_cpu = model._fused_ce_table(cparams, torch.device("cpu"))
    assert (on_cpu is None) == (mode == "auto")


def test_decode_attention_has_no_length_gate(plain_forbidden):
    """A cache far past the old 442-position cap reaches the kernel's
    launch (which raises here, where nothing can build it), not a
    length check."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel would run")
    r, h, dh, L = 2, 2, 64, 5000
    with pytest.raises(RuntimeError, match="nvcc|CUDA"):
        dmod.decode_attention(_cuda_typed(r, h, 1, dh),
                              _cuda_typed(r, h, 1, dh),
                              _cuda_typed(r, h, 1, dh),
                              _cuda_typed(r, h, L, dh),
                              _cuda_typed(r, h, L, dh), L - 1)
    assert not hasattr(dmod, "max_len")


@pytest.fixture
def flash_plain_forbidden(monkeypatch):
    for name in ("flash_attention_reference",
                 "flash_attention_bwd_reference"):
        monkeypatch.setattr(famod, name, lambda *a, **k: pytest.fail(
            "a flash wrapper ran its plain version on a CUDA tensor"))


def test_flash_wrappers_raise_on_cuda_request(flash_plain_forbidden):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel would run")
    b, h, t, dh = 1, 2, 5, 16
    q, k, v, do, out = (_cuda_typed(b, h, t, dh) for _ in range(5))
    lse = _cuda_typed(b, h, t)
    before = (famod.flash_attention_fwd.launches,
              famod.flash_attention_dq.launches,
              famod.flash_attention_dkv.launches)
    with pytest.raises(RuntimeError):
        famod.flash_attention_fwd(q, k, v)
    with pytest.raises(RuntimeError):
        famod.flash_attention_bwd(q, k, v, None, do, out, lse)
    # with a gradient: the autograd Function's forward is the kernel
    with pytest.raises(RuntimeError):
        famod.flash_attention(_cuda_typed(b, h, t, dh).requires_grad_(True),
                              k, v, causal=True)
    # a head size past the largest the kernels are built for is refused
    # by name, not bypassed; a smaller one they are not built for runs
    # zero-padded to a built one, so it reaches the launch
    with pytest.raises(ValueError, match="head size 256"):
        famod.flash_attention_fwd(*(_cuda_typed(b, h, t, 256)
                                    for _ in range(3)))
    with pytest.raises(RuntimeError):
        famod.flash_attention_fwd(*(_cuda_typed(b, h, t, 8)
                                    for _ in range(3)))
    assert (famod.flash_attention_fwd.launches,
            famod.flash_attention_dq.launches,
            famod.flash_attention_dkv.launches) == before


@pytest.mark.parametrize("flash,t,taken", [
    ("auto", 1024, True), ("auto", 1023, False), ("on", 16, True),
    ("off", 1024, False)])
def test_dispatcher_flash_gate(monkeypatch, flash, t, taken):
    """The reference's gate, ahead of the packed one: on a CUDA tensor
    flash 'on', or 'auto' at max(Tq, Tk) >= 1024, calls the flash wrapper
    (which launches the kernel); 'off' and shorter 'auto' calls never
    do."""
    calls = []
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a, **k: calls.append(1) or a[0])
    monkeypatch.setattr(tatt, "packed_attention", lambda q, *a, **k: q)
    q = _cuda_typed(1, 1, 4, 16)
    k = _cuda_typed(1, 1, t, 16)
    out, w = tatt.attention(q, k, k, kv_mask=torch.ones(1, t), flash=flash)
    assert w is None and len(calls) == int(taken)


@pytest.mark.parametrize("value,want", [("auto", "auto"), ("dense", "off"),
                                        ("flash", "on")])
def test_attention_kernel_alias(value, want):
    for mode, head in (("translation", ["--models", "m.npz"]),
                       ("training", ["--train-sets", "a", "b"])):
        opts = parse_options([*head, "--attention-kernel", value], mode=mode)
        assert opts.get("transformer-flash-attention") == want
        # an explicit --transformer-flash-attention wins over the alias
        opts = parse_options([*head, "--attention-kernel", value,
                              "--transformer-flash-attention", "off"],
                             mode=mode)
        assert opts.get("transformer-flash-attention") == "off"
    with pytest.raises(SystemExit):
        parse_options(["--models", "m.npz", "--attention-kernel", "packed"])


def test_auto_tune_is_refused_by_name():
    head = ["--type", "transformer", "--train-sets", "a", "b"]
    opts = parse_options([*head, "--auto-tune"], mode="training")
    with pytest.raises(NotImplementedError, match="--auto-tune"):
        _refuse_unported(opts)
    _refuse_unported(parse_options(head, mode="training"))
