"""B2's operator, `t2r_torch::flash_fwd` (ops/flash_attention.py).

flash_attention's no-gradient forward goes through this torch.library
custom op so a torch.export program records it as one node. On CPU
tensors the op is B2's plain version, bit for bit, for strided q/k/v
views (as the transformer passes them) and every mask option; its fake
gives a contiguous [B, S, H, D] tensor of q's dtype; torch.library's
opcheck holds the registration (schema, fake, dispatch) together.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.ops import flash_attention as fa

CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=5),
    "q_offset": dict(causal=True, q_offset=7),
    "full": dict(causal=False),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _qkv(dtype=torch.float32, batch=2, seq=40, heads=2, dim=16, seed=0):
    rng = np.random.RandomState(seed)
    fused = torch.from_numpy(rng.randn(batch, seq, 3, heads, dim).astype(np.float32))
    fused = fused.to(dtype)
    return fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]  # strided views


def _args(case):
    kw = dict(causal=False, q_offset=0, k_offset=0, window=None)
    kw.update(CASES[case])
    return kw


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_is_the_plain_version_on_cpu(case, dtype):
    q, k, v = _qkv(dtype)
    kw = _args(case)
    scale = q.shape[-1] ** -0.5
    got = fa.flash_fwd_op(q, k, v, kw["causal"], scale, kw["q_offset"],
                          kw["k_offset"], kw["window"])
    want = fa.flash_attention_plain(q, k, v, scale=scale, **kw)
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(q, k, v, scale=scale, **kw), want)


def test_no_grad_path_calls_the_op_and_grad_path_does_not(monkeypatch):
    calls = []
    original = fa.flash_fwd_op

    def spy(*args):
        calls.append(args)
        return original(*args)

    monkeypatch.setattr(fa, "flash_fwd_op", spy)
    q, k, v = _qkv()
    with torch.no_grad():
        fa.flash_attention(q, k, v, causal=True)
    assert len(calls) == 1
    q.requires_grad_(True)
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert len(calls) == 1 and q.grad is not None


def test_fake_is_contiguous_in_q_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = (torch.empty(2, 8, 3, 2, 16).transpose(1, 2)[:, :, 0]
                   for _ in range(3))
        out = torch.ops.t2r_torch.flash_fwd(q, k, v, True, 0.25, 0, 0, None)
    assert out.shape == q.shape and out.dtype == q.dtype and out.is_contiguous()


@pytest.mark.parametrize("case", ["causal", "window"])
def test_opcheck(case):
    q, k, v = (t.contiguous() for t in _qkv(seq=20))
    kw = _args(case)
    torch.library.opcheck(
        fa.flash_fwd_op,
        (q, k, v, kw["causal"], 0.25, kw["q_offset"], kw["k_offset"], kw["window"]),
        test_utils=("test_schema", "test_faketensor"),
    )
