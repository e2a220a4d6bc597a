"""Switch MoE of the PyTorch port (ops/moe_kernel.py, parallel/moe.py) against the JAX package.

- CPU: the port's dispatch/combine (their plain versions on a CPU tensor)
  equal the JAX Pallas kernels (interpreter) and the JAX oracles on the
  same seeded inputs, including a ragged tile, a single tile, capacity 1
  and tied probabilities; the plain backward of each kernel
  (``dispatch_backward_reference``, ``combine_backward_reference``) equals
  ``jax.vjp`` through the JAX oracles, with and without ties and drops; the
  port's index-op backward equals
  ``jax.value_and_grad`` through the JAX fused path and autograd through
  the port's own oracle; ``switch_moe`` over a 4-rank ``gloo`` group equals
  the JAX ``switch_moe(fused=True)`` on a 4-device expert mesh (loss, out,
  gate and expert gradients, the bf16 overflow boundary); the wrappers'
  input checks; ``convert.moe_from_jax``.
The card-only tests are in tests/test_torch_gpu.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from _torch_moe_worker import run_ranks
from distribuuuu_tpu.ops import moe_kernel as jmk
from distribuuuu_tpu.parallel import moe as jmoe
from distribuuuu_tpu.runtime import create_mesh
from distribuuuu_tpu_torch.convert import moe_from_jax
from distribuuuu_tpu_torch.ops import moe_kernel as mk
from distribuuuu_tpu_torch.parallel import moe as tmoe

torch.set_num_threads(2)  # the suite runs several test workers on one host

D, E = 8, 8


def _inputs(n, d=D, e=E, seed=0, tied=False):
    """Seeded numpy (x, gate) as in tests/test_moe_kernel.py; ``tied`` makes
    gate columns 0 and 1 equal, so every token's first two probabilities tie."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    gate = rng.standard_normal((d, e)).astype(np.float32)
    if tied:
        gate[:, 1] = gate[:, 0]
    return x, gate


# ragged last tile (n % block_n != 0), a single-tile grid, capacity 1: the
# cases of tests/test_moe_kernel.py::test_dispatch_matches_oracle
DISPATCH_CASES = [(37, 3, 16), (64, 2, 64), (8, 1, 128)]


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,capacity,block_n", DISPATCH_CASES)
def test_dispatch_matches_jax_kernel_and_oracle(n, capacity, block_n, x_dtype):
    x, gate = _inputs(n)
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    xj = jnp.asarray(x, getattr(jnp, x_dtype))
    got = [a.numpy() for a in mk.fused_moe_dispatch(xt, torch.from_numpy(gate), capacity=capacity)]
    kernel = jmk.fused_moe_dispatch(xj, jnp.asarray(gate), capacity=capacity, block_n=block_n,
                                    interpret=True)
    oracle = jmk.oracle_dispatch(xj, jnp.asarray(gate), capacity)
    for want in (kernel, oracle):
        send, top, pos, w, fp = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(got[1], top)
        np.testing.assert_array_equal(got[2], pos)
        np.testing.assert_allclose(got[0], send, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[3], w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[4], fp, rtol=1e-6, atol=1e-6)
    assert got[1].dtype == np.int32 and got[2].dtype == np.int32
    # slots no kept token fills are exact zeros
    filled = np.zeros((E, capacity), bool)
    filled[got[1][got[3] != 0], got[2][got[3] != 0]] = True
    assert (got[0][~filled] == 0).all()


def test_combine_matches_jax_kernel_and_drops_to_zero():
    n, capacity = 29, 2
    x, gate = _inputs(n, seed=3)
    _, top, pos, w, _ = jmk.fused_moe_dispatch(jnp.asarray(x), jnp.asarray(gate),
                                              capacity=capacity, block_n=16, interpret=True)
    back = np.random.default_rng(4).standard_normal((E, capacity, D)).astype(np.float32)
    got = mk.fused_moe_combine(*(torch.from_numpy(np.array(a)) for a in (back, top, pos, w))).numpy()
    for want in (jmk.fused_moe_combine(jnp.asarray(back), top, pos, w, block_n=16, interpret=True),
                 jmk.oracle_combine(jnp.asarray(back), top, pos, w)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    dropped = np.asarray(w) == 0.0
    assert dropped.any(), "no overflow at this capacity: dead test"
    np.testing.assert_array_equal(got[dropped], 0.0)


def _soak_loss_jax(capacity):
    def f(x_, g_, b_):
        send, top, pos, w, fp = jmk.fused_moe_dispatch(x_, g_, capacity=capacity, block_n=16,
                                                       interpret=True)
        out = jmk.fused_moe_combine(jnp.tanh(send) + b_, top, pos, w, block_n=16, interpret=True)
        return jnp.sum(out**2) + 0.01 * jnp.sum(fp[0] * fp[1])
    return f


def _soak_loss_torch(dispatch, combine):
    def f(x_, g_, b_):
        send, top, pos, w, fp = dispatch(x_, g_)
        out = combine(torch.tanh(send) + b_, top, pos, w)
        return (out**2).sum() + 0.01 * (fp[0] * fp[1]).sum()
    return f


@pytest.mark.parametrize("tied", [False, True])
def test_grads_match_jax_fused_path(tied):
    """d/d{x, gate, b0} of the soak's loss through dispatch -> tanh(send) +
    b0 -> combine: the port's index-op backward against jax.value_and_grad
    through the JAX fused path (whose backward recomputes the einsum
    formulation). ``tied``: the gradient of top_p goes to the argmax alone."""
    n, capacity = 37, 3
    x, gate = _inputs(n, seed=5, tied=tied)
    b0 = np.random.default_rng(6).standard_normal((E, capacity, D)).astype(np.float32)
    vj, gj = jax.value_and_grad(_soak_loss_jax(capacity), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gate), jnp.asarray(b0))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, gate, b0)]
    loss = _soak_loss_torch(lambda a, b: mk.fused_moe_dispatch(a, b, capacity=capacity),
                            mk.fused_moe_combine)(*args)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(vj), rtol=1e-6)
    # rtol 1e-5 as tests/test_moe_kernel.py; XLA and torch sum in other
    # orders, so an entry that cancels keeps the rounding of its larger
    # terms: atol 1e-6 of the gradient's scale
    for a, b in zip(args, gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(np.abs(b).max())))
    if tied:  # the tie was real: the lower expert won every tied token
        top = mk.fused_moe_dispatch(args[0].detach(), args[1].detach(), capacity=capacity)[1]
        assert (top != 1).all()


def test_index_op_backward_matches_autograd_through_the_oracle():
    """The autograd Functions' backward (gather / index_add_ / softmax
    backward, no [n, E, C] mask) against plain autograd through the port's
    einsum oracles, bf16 x included."""
    n, capacity = 53, 4
    for x_dtype, seed in ((torch.float32, 7), (torch.bfloat16, 8)):
        x, gate = _inputs(n, seed=seed)
        b0 = np.random.default_rng(seed).standard_normal((E, capacity, D)).astype(np.float32)
        grads = []
        for dispatch, combine in (
                (lambda a, b: mk.fused_moe_dispatch(a, b, capacity=capacity), mk.fused_moe_combine),
                (lambda a, b: mk.oracle_dispatch(a, b, capacity), mk.oracle_combine)):
            args = [torch.from_numpy(x).to(x_dtype).requires_grad_(),
                    torch.from_numpy(gate).requires_grad_(), torch.from_numpy(b0).requires_grad_()]
            _soak_loss_torch(dispatch, combine)(*args).backward()
            grads.append([a.grad.float().numpy() for a in args])
        rtol = 1e-5 if x_dtype == torch.float32 else 2.0**-8  # d_x is rounded to bf16
        for a, b in zip(*grads):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)


# (tied gate columns, capacity) at n 41, E 8: capacity 16 keeps every token,
# capacity 3 drops some; tied: every token's first two probabilities tie
BWD_CASES = [(False, 16), (False, 3), (True, 16), (True, 3)]
BWD_N = 41


def _bwd_routing(tied, capacity):
    """Seeded (x, gate) and the JAX oracle's routing; the case drops tokens
    exactly when it says it does."""
    x, gate = _inputs(BWD_N, seed=13, tied=tied)
    _, top, pos, w, _ = jmk.oracle_dispatch(jnp.asarray(x), jnp.asarray(gate), capacity)
    top, pos, w = (np.array(a) for a in (top, pos, w))
    assert bool((w == 0).any()) == (capacity == 3), "the case does not drop as it says"
    if tied:
        assert (top != 1).all()  # the lower expert won every tied token
    return x, gate, top, pos, w


def _close(got, want):
    """rtol 1e-5 as tests/test_moe_kernel.py; XLA and torch sum in other
    orders, so an entry that cancels keeps the rounding of its larger terms:
    atol 1e-6 of the gradient's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("tied,capacity", BWD_CASES)
def test_dispatch_backward_reference_matches_jax_vjp(tied, capacity):
    """K6's plain backward against jax.vjp through the JAX oracle_dispatch,
    for seeded cotangents of send, w and fp_sum (fp_sum[0] is a count: its
    cotangent must carry nothing)."""
    x, gate, top, pos, w = _bwd_routing(tied, capacity)
    rng = np.random.default_rng(14)
    d_send = rng.standard_normal((E, capacity, D)).astype(np.float32)
    d_w = rng.standard_normal(BWD_N).astype(np.float32)
    d_fp = rng.standard_normal((2, E)).astype(np.float32)

    def diff_outputs(x_, g_):
        send, _top, _pos, w_, fp = jmk.oracle_dispatch(x_, g_, capacity)
        return send, w_, fp

    _, pull = jax.vjp(diff_outputs, jnp.asarray(x), jnp.asarray(gate))
    want_x, want_gate = pull((jnp.asarray(d_send), jnp.asarray(d_w), jnp.asarray(d_fp)))
    d_x, d_gate = mk.dispatch_backward_reference(
        torch.from_numpy(x), torch.from_numpy(gate), torch.from_numpy(top), torch.from_numpy(pos),
        torch.from_numpy(w), torch.from_numpy(d_send), torch.from_numpy(d_w),
        torch.from_numpy(d_fp), capacity)
    _close(d_x, want_x)
    _close(d_gate, want_gate)
    only_x, none = mk.dispatch_backward_reference(
        torch.from_numpy(x), torch.from_numpy(gate), torch.from_numpy(top), torch.from_numpy(pos),
        torch.from_numpy(w), torch.from_numpy(d_send), torch.from_numpy(d_w),
        torch.from_numpy(d_fp), capacity, need_gate=False)
    assert none is None and torch.equal(only_x, d_x)


@pytest.mark.parametrize("tied,capacity,reroute",
                         [(t, c, False) for t, c in BWD_CASES] + [(False, 3, True)])
def test_combine_backward_reference_matches_jax_vjp(tied, capacity, reroute):
    """K7's plain backward against jax.vjp through the JAX oracle_combine on
    the oracle's routing: d_back (zeros in every slot no kept token fills)
    and d_w (dropped tokens included). ``reroute``: a routing dispatch does
    not make, with a kept token's w set to 0 (its slot gets zeros) and a
    second token with w != 0 moved into a kept token's slot (the slot gets
    both w·g)."""
    _, _, top, pos, w = _bwd_routing(tied, capacity)
    kept = np.flatnonzero(w != 0)
    if reroute:
        w, top, pos = w.copy(), top.copy(), pos.copy()
        w[kept[0]] = 0.0
        top[kept[2]], pos[kept[2]] = top[kept[1]], pos[kept[1]]
    rng = np.random.default_rng(15)
    back = rng.standard_normal((E, capacity, D)).astype(np.float32)
    g = rng.standard_normal((BWD_N, D)).astype(np.float32)
    _, pull = jax.vjp(lambda b_, w_: jmk.oracle_combine(b_, jnp.asarray(top), jnp.asarray(pos), w_),
                      jnp.asarray(back), jnp.asarray(w))
    want_back, want_w = pull(jnp.asarray(g))
    d_back, d_w = mk.combine_backward_reference(
        torch.from_numpy(back), torch.from_numpy(top), torch.from_numpy(pos), torch.from_numpy(w),
        torch.from_numpy(g))
    _close(d_back, want_back)
    _close(d_w, want_w)
    filled = np.zeros((E, capacity), bool)
    filled[top[w != 0], pos[w != 0]] = True
    assert (d_back.numpy()[~filled] == 0).all()
    if reroute:
        np.testing.assert_allclose(d_back.numpy()[top[kept[1]], pos[kept[1]]],
                                   w[kept[1]] * g[kept[1]] + w[kept[2]] * g[kept[2]], rtol=1e-6)


def test_token_slot_positions_is_int32_and_matches_jax():
    top = np.random.default_rng(9).integers(0, E, 97)
    onehot = np.eye(E, dtype=np.float32)[top]
    got = tmoe.token_slot_positions(torch.from_numpy(onehot))
    assert got.dtype == torch.int32
    want = np.asarray(jmoe.token_slot_positions(jnp.asarray(onehot)))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    x, gate = torch.zeros(4, D), torch.zeros(D, E)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.fused_moe_dispatch(x.to("meta"), gate.to("meta"), capacity=2)
    with pytest.raises(TypeError, match="gate_kernel must be float32"):
        mk.fused_moe_dispatch(x, gate.double(), capacity=2)
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        mk.fused_moe_dispatch(x.half(), gate, capacity=2)
    with pytest.raises(ValueError, match="capacity"):
        mk.fused_moe_dispatch(x, gate, capacity=0)
    # the shared-memory and width checks the CUDA path makes before launching
    with pytest.raises(ValueError, match="at most 32 experts"):
        mk.check_kernel_shape(8, 128, 33, 4)
    with pytest.raises(ValueError, match="shared memory"):
        mk.check_kernel_shape(8, 8192, 8, 4)
    mk.check_kernel_shape(8192, 768, 8, 1280)  # the Switch-Base width fits
    back = torch.zeros(E, 2, D)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="top must be"):
        mk.fused_moe_combine(back, idx.long(), idx, torch.zeros(4))
    with pytest.raises(ValueError, match="back must be float32"):
        mk.fused_moe_combine(back.bfloat16(), idx, idx, torch.zeros(4))


def test_moe_from_jax_layout():
    rng = np.random.default_rng(10)
    params = {"gate": rng.standard_normal((D, 4)),
              "experts": {"w": rng.standard_normal((4, D, 16)), "v": rng.standard_normal((4, 16, D))}}
    gate, experts = moe_from_jax(params, 2)
    assert gate.dtype == torch.float32 and gate.shape == (D, 4)
    np.testing.assert_array_equal(experts["w"].numpy(), params["experts"]["w"][2].astype(np.float32))
    np.testing.assert_array_equal(experts["v"].numpy(), params["experts"]["v"][2].astype(np.float32))
    with pytest.raises(ValueError, match="rank 4"):
        moe_from_jax(params, 4)


# --- switch_moe over 4 ranks vs the JAX expert mesh ------------------------

WORLD, N_LOCAL, HIDDEN = 4, 6, 2 * D
# (name, capacity, x dtype, overflow boundary); the JAX tests' bounds:
# (loss rtol, grad rtol, grad atol)
DIST_CASES = {
    "f32_c2": (2, "float32", False, (1e-6, 1e-5, 1e-6)),
    "f32_c4": (4, "float32", False, (1e-6, 1e-5, 1e-6)),
    "bf16_overflow": (N_LOCAL - 1, "bfloat16", True, (1e-5, 1e-4, 1e-5)),
}


def _dist_inputs(overflow: bool) -> dict:
    """tests/test_moe_kernel.py's setup as numpy: x, y [E, n_local, D], a
    0.7-scaled gate, 0.5-scaled experts; ``overflow``: positive tokens and
    only expert 0's gate column set, so each rank's last token drops."""
    rng = np.random.default_rng(11 if overflow else 12)
    x = rng.standard_normal((WORLD, N_LOCAL, D)).astype(np.float32)
    gate = (0.7 * rng.standard_normal((D, WORLD))).astype(np.float32)
    if overflow:
        x = np.abs(x) + 0.1
        gate = np.zeros((D, WORLD), np.float32)
        gate[:, 0] = 5.0
    return dict(x=x, y=rng.standard_normal((WORLD, N_LOCAL, D)).astype(np.float32), gate=gate,
                w=(0.5 * rng.standard_normal((WORLD, D, HIDDEN))).astype(np.float32),
                v=(0.5 * rng.standard_normal((WORLD, HIDDEN, D))).astype(np.float32))


def _jax_expert_fn(p, h):
    return jnp.tanh(h @ p["w"]) @ p["v"]


def _jax_switch_moe(data: dict, capacity: int, dtype):
    """Loss (pmean), gate grad (pmean), expert grads / E and out of the JAX
    switch_moe(fused=True, interpret=True) on a 4-device expert mesh."""
    mesh = create_mesh({"expert": WORLD}, devices=jax.devices()[:WORLD])

    def body(gate, experts, x_local, y_local):
        experts = jax.tree.map(lambda a: a[0], experts)
        x_local, y_local = x_local[0], y_local[0]

        def loss_fn(p):
            out, aux = jmoe.switch_moe(x_local.astype(dtype), p["gate"], p["experts"],
                                       _jax_expert_fn, capacity=capacity, axis_name="expert",
                                       fused=True, interpret=True)
            out = out.astype(jnp.float32)
            return jnp.mean((out - y_local) ** 2) + 0.01 * aux, out

        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            {"gate": gate, "experts": experts})
        return (lax.pmean(loss, "expert"), lax.pmean(grads["gate"], "expert"),
                jax.tree.map(lambda g: g[None] / WORLD, grads["experts"]), out[None])

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P("expert"), P("expert"), P("expert")),
                              out_specs=(P(), P(), P("expert"), P("expert")), check_vma=False))
    loss, g_gate, g_exp, out = f(jnp.asarray(data["gate"]),
                                 {"w": jnp.asarray(data["w"]), "v": jnp.asarray(data["v"])},
                                 jnp.asarray(data["x"]), jnp.asarray(data["y"]))
    return dict(loss=float(loss), gate_grad=np.asarray(g_gate), w_grad=np.asarray(g_exp["w"]),
                v_grad=np.asarray(g_exp["v"]), out=np.asarray(out))


@pytest.fixture(scope="module")
def torch_ranks(tmp_path_factory):
    """One 4-rank gloo run of every case (ranks spawned with a file:// store,
    killed at a 120 s deadline); each case's inputs beside it."""
    tmp = tmp_path_factory.mktemp("torch_moe")
    cases, data = [], {}
    for name, (capacity, dtype, overflow, _) in DIST_CASES.items():
        data[name] = _dist_inputs(overflow)
        np.savez(tmp / f"{name}.npz", **data[name])
        cases.append(dict(name=name, inputs=str(tmp / f"{name}.npz"), device="cpu", dtype=dtype,
                          capacity=capacity, residual=False))
    ranks = run_ranks(dict(world=WORLD, threads=1, timeout_s=100, cases=cases), Path(tmp) / "ranks",
                      deadline_s=120)
    return ranks, data


@pytest.mark.parametrize("name", list(DIST_CASES))
def test_switch_moe_over_gloo_matches_jax_expert_mesh(torch_ranks, name):
    ranks, data = torch_ranks
    capacity, dtype, overflow, (loss_rtol, grad_rtol, grad_atol) = DIST_CASES[name]
    want = _jax_switch_moe(data[name], capacity, getattr(jnp, dtype))
    for r, res in enumerate(ranks):
        assert res[f"{name}/launches"].tolist() == [0, 0]  # CPU tensors: the plain versions
        assert res[f"{name}/bwd_launches"].tolist() == [0, 0]
        np.testing.assert_allclose(float(res[f"{name}/loss"]), want["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(res[f"{name}/gate_grad"], want["gate_grad"], rtol=grad_rtol,
                                   atol=grad_atol)
        for k in ("w_grad", "v_grad"):
            np.testing.assert_allclose(res[f"{name}/{k}"], want[k][r], rtol=grad_rtol, atol=grad_atol)
        out = res[f"{name}/out"]
        np.testing.assert_allclose(out, want["out"][r], rtol=grad_rtol, atol=grad_atol)
        if overflow:  # exactly the last local token drops, to exact zeros on both sides
            assert np.abs(out[:capacity]).max() > 1e-3
            np.testing.assert_array_equal(out[capacity:], 0.0)
            np.testing.assert_array_equal(want["out"][r][capacity:], 0.0)


def test_switch_moe_rejects_a_gate_wider_than_the_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="one expert per rank"):
            tmoe.switch_moe(torch.zeros(4, D), torch.zeros(D, 2), {}, lambda p, h: h, capacity=2)
    finally:
        dist.destroy_process_group()
