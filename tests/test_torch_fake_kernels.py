"""The kernels' operators for tensors without data (``kernels.fake``), which
the dry run (``launch.dryrun``) reaches through ``kernels.ops``.

For each of the ten wrappers, the same call on ``meta`` tensors and on real
CPU tensors (the plain version) gives outputs of the same shapes and dtypes;
``zo_reconstruct_update`` hands back its own buffers on both; each meta call
counts one in ``fake.CALLS`` and launches nothing; an operator called on real
tensors raises; a fake tensor takes the operator too.
"""
import pytest
import torch

from repro_torch.kernels import fake, ops

BLOCK, NB, M = 256, 3, 2


def _u32(x):
    return torch.as_tensor(x, dtype=torch.int64).to(torch.uint32)


def _flat():
    g = torch.Generator().manual_seed(0)
    return {"x": torch.randn(NB * BLOCK, generator=g),
            "salts": _u32([7, 8, 9]), "msalts": _u32([[1, 2], [3, 4], [5, 6]]),
            "ctrs": _u32([0, BLOCK, 2 * BLOCK]),
            "nvalid": torch.tensor([BLOCK, BLOCK, 100], dtype=torch.int32),
            "bf16": torch.tensor([0, 1, 0], dtype=torch.int32),
            "coeffs": torch.tensor([0.5, -0.25]), "g": g}


CALLS = {
    "zo_perturb_flat": lambda t: ops.zo_perturb_flat(t["x"], t["salts"], t["ctrs"], t["nvalid"],
                                                     1e-3, BLOCK),
    "zo_reconstruct_flat": lambda t: ops.zo_reconstruct_flat(t["msalts"], t["coeffs"], t["ctrs"],
                                                             t["nvalid"], BLOCK),
    "zo_perturb_sumsq": lambda t: ops.zo_perturb_sumsq(t["x"], t["salts"], t["ctrs"], t["nvalid"],
                                                       1e-3, BLOCK),
    "zo_perturb": lambda t: ops.zo_perturb(t["x"][:700], 5, 1e-3, 3),
    "zo_reconstruct": lambda t: ops.zo_reconstruct(700, t["salts"][:M], t["coeffs"], 3),
    "flash_attention": lambda t: ops.flash_attention(t["q"], t["k"], t["k"], causal=True,
                                                     window=32, softcap=30.0),
    "selective_scan": lambda t: ops.selective_scan(t["u"], t["u"], t["bm"], t["bm"], t["A"],
                                                   t["D"]),
    "selective_scan_state": lambda t: ops.selective_scan(t["u"], t["u"], t["bm"], t["bm"],
                                                         t["A"], t["D"], return_state=True),
    "rmsnorm": lambda t: ops.rmsnorm(t["h"], t["scale"]),
}


def _inputs(device):
    t = _flat()
    g = t.pop("g")
    t.update(q=torch.randn(1, 64, 4, 32, generator=g), k=torch.randn(1, 64, 2, 32, generator=g),
             u=torch.randn(2, 16, 8, generator=g) * 0.1, bm=torch.randn(2, 16, 4, generator=g),
             A=-torch.rand(8, 4, generator=g), D=torch.ones(8),
             h=torch.randn(3, 5, 64, generator=g), scale=torch.zeros(64))
    return {k: v.to(device) for k, v in t.items()}


def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_meta_outputs_match_the_plain_versions(name):
    fake.reset_calls()
    ops.reset_launch_counts()
    got = CALLS[name](_inputs("meta"))
    want = CALLS[name](_inputs("cpu"))
    assert _sig(got) == _sig(want)
    assert all(o.device.type == "meta" for o in (got if isinstance(got, tuple) else (got,)))
    assert fake.CALLS[name.replace("_state", "")] == 1
    assert sum(fake.CALLS.values()) == 1 and sum(ops.launch_counts().values()) == 0


def test_zo_sumsq_and_the_in_place_update():
    fake.reset_calls()
    got, want = ops.zo_sumsq(1000, 3, 5, device="meta"), ops.zo_sumsq(1000, 3, 5, device="cpu")
    assert _sig(got) == _sig(want) and got.device.type == "meta"
    for device in ("meta", "cpu"):
        t = _inputs(device)
        p, mom = t["x"].clone(), torch.zeros_like(t["x"])
        out = ops.zo_reconstruct_update(p, mom, t["msalts"], t["ctrs"], t["nvalid"], t["bf16"],
                                        t["coeffs"], 0.05, 0.9, BLOCK)
        assert out[0] is p and out[1] is mom
    assert fake.CALLS["zo_sumsq"] == 1 and fake.CALLS["zo_reconstruct_update"] == 1


def test_operators_refuse_real_tensors_and_take_fake_ones():
    t = _inputs("cpu")
    with pytest.raises(RuntimeError, match="fake tensors only"):
        torch.ops.repro_torch.rmsnorm(t["h"], t["scale"], 1e-6)
    with pytest.raises(ValueError, match="expected float32"):
        ops.zo_perturb_flat(t["x"][:100].to("meta"), t["salts"].to("meta"), t["ctrs"].to("meta"),
                            t["nvalid"].to("meta"), 1e-3, BLOCK)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        q = mode.from_tensor(t["q"])
        k = mode.from_tensor(t["k"])
        out = ops.flash_attention(q, k, k)
    assert tuple(out.shape) == tuple(t["q"].shape) and out.dtype == t["q"].dtype
