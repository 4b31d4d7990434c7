"""Rules around the port's flash-attention kernels, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there).  Here: the CUDA sources stand alone
(no cuBLAS, cuDNN or CUTLASS/CuTe header), no module of the port calls
PyTorch's fused attention or ``torch.compile``, the bf16 entry is written
on tensor cores fed by asynchronous copies, every refusal of the wrapper
raises on CPU tensors before anything is built or launched, and
``ops.flash_attention`` on CPU tensors is the plain version, gradient
included (head_dim 128 too), and every kernel keeps its tiles in dynamic
shared memory, allowed once for each instance, within the H100's 227 KB
a block at every head dim the wrapper takes.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FLASH_CU = build.CSRC / "flash_attention.cu"


@pytest.mark.parametrize("src", build.sources(), ids=lambda p: p.name)
def test_csrc_includes_no_library_gemm_header(src):
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]',
                          src.read_text(), flags=re.M)
    banned = [h for h in includes
              if re.search(r"cublas|cudnn|cutlass|cute/", h, flags=re.I)]
    assert includes and not banned, f"{src.name} includes {banned}"


def _fused_attention_or_compile_calls(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and (
                node.attr == "scaled_dot_product_attention"
                or (node.attr == "compile" and isinstance(node.value, ast.Name)
                    and node.value.id == "torch")):
            yield node.attr
        elif isinstance(node, ast.ImportFrom):
            yield from (a.name for a in node.names
                        if a.name in ("scaled_dot_product_attention",
                                      "compile"))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_calls_no_sdpa_or_torch_compile(path):
    found = list(_fused_attention_or_compile_calls(path))
    assert not found, f"{path.name} uses {found}"


def test_bf16_entry_runs_tensor_cores_on_async_copies():
    """The bf16 kernels' products are mma.sync on bf16 with f32
    accumulators, their tiles arrive by cp.async (zero-filled past S by
    src-size) and reach the fragments by ldmatrix; each dtype has its
    path."""
    text = FLASH_CU.read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert re.search(r"cp\.async\.cg\.shared\.global \[%0\], \[%1\], 16, %2",
                     text)
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in text
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in text
    for part in ("fwd", "bwd_dq", "bwd_dkv"):
        # each tensor-core kernel is defined on bf16 and launched
        assert re.search(rf"flash_{part}_mma_kernel\(const bf16\*", text)
        assert f"flash_{part}_mma_kernel<DH><<<" in text
        assert re.search(rf"flash_{part}_fma_kernel\(const float\*", text)
    assert set(fa_mod.PATHS) == set(fa_mod.DTYPES)
    assert fa_mod.PATHS[torch.bfloat16] == "tensor-core"


# the kernels' tiles at head dim dh, in bytes (csrc/flash_attention.cu):
# bf16 tiles of 64 rows of dh + 8 values; two f32 tiles of 64 x dh
def _bf16_tile(dh):
    return 64 * (dh + 8) * 2


SMEM = {"fwd_mma": lambda dh: 5 * _bf16_tile(dh),
        "dq_mma": lambda dh: 4 * _bf16_tile(dh),
        "dkv_mma": lambda dh: (4 if dh <= 64 else 6) * _bf16_tile(dh),
        "fma": lambda dh: 2 * 64 * dh * 4}
H100_SMEM_A_BLOCK = 232_448


def test_head_dim_128_tiles_in_dynamic_shared_memory():
    """Every kernel takes its tiles from ``extern __shared__`` (no static
    tile array, whose limit is 48 KB), the launches pass the size, each
    instance's attribute is set once a device (a function-local static of
    one flag a device, since the attribute belongs to a device's context)
    and its error returned, both C entries take head dim 128, and the
    largest kernel at 128 fits a block of the H100."""
    text = FLASH_CU.read_text()
    assert fa_mod.HEAD_DIMS == (16, 32, 64, 128)
    assert not re.search(r"__shared__[^;]*Tile<DH>", text)
    assert not re.search(r"__shared__[^;]*\[k(BlockK|Rows)\]\[DH\]", text)
    kernels = re.findall(r"__global__ void[^{]*?(flash_\w+_kernel)\(", text)
    assert sorted(kernels) == sorted(
        f"flash_{p}_{k}_kernel" for p in ("fwd", "bwd_dq", "bwd_dkv")
        for k in ("mma", "fma"))
    bodies = re.split(r"__global__ void", text)[1:]
    assert all("extern __shared__ __align__(128) unsigned char flash_smem[]"
               in body for body in bodies)
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text
    allowed = re.findall(r"static SmemAllowed (\w+);\s*const cudaError_t "
                         r"(\w+) =\s*allow_smem\((\w+), (flash_\w+_kernel)"
                         r"<DH>", text)
    assert sorted(k for *_, k in allowed) == sorted(kernels)
    for flags, name, passed, _ in allowed:
        assert passed == flags
        assert f"if ({name} != cudaSuccess) return {name};" in text
    helper = text[text.index("cudaError_t allow_smem("):]
    helper = helper[:helper.index("\n}\n")]
    assert "cudaGetDevice(&dev)" in helper
    assert re.search(r"if \(tracked && on\[dev\]\.load\(", helper)
    assert re.search(r"if \(err == cudaSuccess && tracked\)\s*"
                     r"on\[dev\]\.store\(true", helper)
    for entry in ("launch_fwd", "launch_bwd"):
        assert re.search(rf"case 128:\s*return static_cast<int>\("
                         rf"{entry}<128>", text)
    for dh in fa_mod.HEAD_DIMS:
        assert max(f(dh) for f in SMEM.values()) <= H100_SMEM_A_BLOCK
    assert SMEM["fwd_mma"](128) == 87_040 > 48 * 1024


def _counts():
    return fa_mod.launches, fa_mod.bwd_launches


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


Q, KV = (1, 8, 4, 16), (1, 8, 2, 16)
LSE = (1, 4, 8)

# (name, call, exception, message): every refusal of the wrapper
REFUSALS = [
    ("fwd float16", lambda: fa_mod.flash_attention_fwd(
        _t(Q, torch.float16), _t(KV, torch.float16), _t(KV, torch.float16)),
     TypeError, "float32 or bfloat16"),
    ("fwd mixed dtypes", lambda: fa_mod.flash_attention_fwd(
        _t(Q), _t(KV, torch.bfloat16), _t(KV)), TypeError, "one dtype"),
    ("fwd 3-d q", lambda: fa_mod.flash_attention_fwd(
        _t(Q[1:]), _t(KV), _t(KV)), ValueError, "q must be"),
    ("fwd k, v shapes differ", lambda: fa_mod.flash_attention_fwd(
        _t(Q), _t(KV), _t((1, 9, 2, 16))), ValueError, "q must be"),
    ("fwd Hq not a multiple of Hkv", lambda: fa_mod.flash_attention_fwd(
        _t(Q), _t((1, 8, 3, 16)), _t((1, 8, 3, 16))), ValueError,
     "incompatible"),
    ("fwd Skv = 0", lambda: fa_mod.flash_attention_fwd(
        _t(Q), _t((1, 0, 2, 16)), _t((1, 0, 2, 16))), ValueError,
     "incompatible"),
    ("fwd head_dim 48", lambda: fa_mod.flash_attention_fwd(
        _t((1, 8, 4, 48)), _t((1, 8, 2, 48)), _t((1, 8, 2, 48))),
     ValueError, "head_dim"),
    ("fwd negative window", lambda: fa_mod.flash_attention_fwd(
        _t(Q), _t(KV), _t(KV), sliding_window=-1), ValueError,
     "sliding_window"),
    ("fwd CPU tensors", lambda: fa_mod.flash_attention_fwd(
        _t(Q), _t(KV), _t(KV)), ValueError, "CUDA"),
    ("autograd CPU tensors", lambda: fa_mod.flash_attention(
        _t(Q, torch.bfloat16), _t(KV, torch.bfloat16),
        _t(KV, torch.bfloat16)), ValueError, "CUDA"),
    ("bwd do dtype", lambda: fa_mod.flash_attention_bwd(
        _t(Q), _t(KV), _t(KV), _t(Q), _t(LSE), _t(Q, torch.bfloat16)),
     TypeError, "one dtype"),
    ("bwd o shape", lambda: fa_mod.flash_attention_bwd(
        _t(Q), _t(KV), _t(KV), _t((1, 7, 4, 16)), _t(LSE), _t(Q)),
     ValueError, "o and do"),
    ("bwd lse shape", lambda: fa_mod.flash_attention_bwd(
        _t(Q), _t(KV), _t(KV), _t(Q), _t((1, 8, 4)), _t(Q)), ValueError,
     "lse must be"),
    ("bwd lse dtype", lambda: fa_mod.flash_attention_bwd(
        _t(Q), _t(KV), _t(KV), _t(Q), _t(LSE, torch.bfloat16), _t(Q)),
     ValueError, "lse must be"),
    ("bwd rows that see no key", lambda: fa_mod.flash_attention_bwd(
        _t(Q), _t((1, 4, 2, 16)), _t((1, 4, 2, 16)), _t(Q), _t(LSE), _t(Q),
        sliding_window=4), ValueError, "see no key"),
    ("bwd CPU tensors", lambda: fa_mod.flash_attention_bwd(
        _t(Q), _t(KV), _t(KV), _t(Q), _t(LSE), _t(Q)), ValueError, "CUDA"),
]


@pytest.mark.parametrize("call,exc,msg", [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_wrapper_refusals_raise_before_any_launch(monkeypatch, call, exc,
                                                  msg):
    def no_build():
        raise AssertionError("the kernels were built or loaded")
    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build", no_build)
    before = _counts()
    with pytest.raises(exc, match=msg):
        call()
    assert _counts() == before


def _qkvdo(seed, b, sq, skv, hq, hkv, dh, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                  ).to(dtype)
                 for shape in ((b, sq, hq, dh), (b, skv, hkv, dh),
                               (b, skv, hkv, dh), (b, sq, hq, dh)))


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 12, 12, 4, 2, 16), True, 0),
    ((1, 9, 13, 4, 4, 32), False, 0),
    ((1, 20, 20, 8, 1, 16), True, 5),
    ((2, 1, 1, 2, 1, 64), True, 0),
    ((1, 10, 10, 6, 2, 128), True, 4),
], ids=["causal-gqa2", "noncausal-ragged-mha", "window5-gqa8", "s1",
        "dh128-window4-gqa3"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ops_flash_on_cpu_is_the_plain_version_and_its_gradient(
        shape, causal, window, dt):
    q, k, v, do = _qkvdo(3, *shape, dt)
    before = _counts()
    out = ops.flash_attention(q, k, v, causal=causal,
                              sliding_window=window)
    assert out.dtype == dt
    assert torch.equal(out, ref.flash_attention(q, k, v, causal=causal,
                                                sliding_window=window))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ops.flash_attention(qg, kg, vg, causal=causal,
                        sliding_window=window).backward(do)
    want = ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                   sliding_window=window)
    for got, w in zip((qg.grad, kg.grad, vg.grad), want):
        assert got.dtype == dt
        if dt == torch.float32:
            # the same f32 graph in both: sums may only differ in order
            assert torch.allclose(got, w, rtol=1e-6, atol=1e-6)
        else:
            # autograd repeats K and V in bf16, so it rounds each query
            # head's dk, dv to bf16 before the GQA sum, where the plain
            # backward sums in f32 and rounds once: 2e-2 of the scale
            err = (got.float() - w.float()).abs().max()
            assert err <= 2e-2 * w.float().abs().max()
    assert _counts() == before
