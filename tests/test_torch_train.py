"""The port's training mode against the JAX package's, on the CPU:
``Unet3D(init_features=2)`` on 32^3 (four pools, as in
``__graft_entry__.py``'s training step), ``Unet2D(features=4)`` on 32^2 and
``FastSurferCNN(num_classes=6, filters=8)`` on 32^2, in float32 and
bfloat16, the Flax variables carried across by ``convert.*_from_jax``
(seeded numpy states, the heads at gain 1 so the probabilities do not
saturate), the inputs and targets from numpy seeds.  The JAX side is
``model.apply(..., train=True, mutable=["batch_stats"])`` under
``jax.value_and_grad`` with the graft entry's BCE (FastSurfer's logits
through a sigmoid first): jitted in float32; eager in bfloat16, since
jitted on the CPU XLA skips the Flax models' bfloat16 roundings.

Bounds (measured worst in the comments):
- train-mode forward: float32 probabilities atol 2e-3, rtol 1e-2 (1.6e-6),
  FastSurfer's logits atol 2e-4 (2.8e-5); bfloat16 probabilities atol 2e-2
  (7.6e-3), FastSurfer's chaotic logits by their 99th percentile within 3%
  of the largest (1.6%), as tests/test_torch_unet.py bounds the eval net;
- the new ``batch_stats``: float32 rtol 1e-4, atol 1e-5 (8.3e-7 abs);
  bfloat16 each difference within 1e-2 of |w| plus the tensor's largest
  |w| (1.8e-3);
- the loss: float32 within 1e-5 (relative) of the graft entry's formula
  evaluated in float64 on the JAX probabilities (3.7e-7; the JAX float32
  mean of 2 x 32^3 terms is itself 1.3e-5 off it); bfloat16 within 1e-2
  of the JAX loss (1.1e-4);
- float32 gradients: each parameter's within 1e-3 of the larger of its
  norm and 1% of the whole gradient's (2.2e-4 of its own; FastSurfer's
  PReLU slopes, sums that cancel to 1e-5 of their terms, are 1.4e-3 off
  by their own norm, and the port's is the closer to a float64 sum).  A
  conv bias that feeds a train-mode batch norm has a zero gradient (the
  norm subtracts the batch's mean): in both packages its computed
  gradient stays below 1e-5 of the whole's (1.5e-6);
- bfloat16 gradients: the per-parameter bound 3e-2 cannot hold, because
  the JAX model's own bfloat16 gradient is 15% (Unet3D), 4.5% (Unet2D)
  and 33% (FastSurfer) of its norm away from its float32 gradient: every
  convolution rounds its cotangents to bfloat16 and each train-mode norm's
  backward cancels most of them.  So the port's bfloat16 gradient is held
  closer to the JAX bfloat16 gradient than that is to the JAX float32
  gradient (port 0.117 / JAX 0.152, 0.010 / 0.045, 0.160 / 0.335), and
  the port's own bfloat16-to-float32 distance within a factor 2 of the
  JAX package's (1.03, 0.98, 0.92), which fails if the port rounds at
  other points.  (XLA on the CPU also sums a bfloat16 bias's cotangent in
  bfloat16: the JAX bias gradients are up to 19% off their float64 sums.)
- one Adam update on identical gradients: atol 1e-7 against
  ``optax.adam(1e-3)`` (5.9e-8), from a fresh state and from a carried one;
- three whole steps from a state carried by ``adam_state_from_jax`` after
  two JAX steps: each step's loss within 1e-4 (2.3e-5), the running
  statistics within 1e-2 as above (2.2e-3), and each parameter's change
  (conv biases before a norm left out) within 0.15 of its norm (0.094):
  Adam divides each element's moment by its root mean square, so the
  rounding of a gradient that is small against the whole (2e-4 of its
  norm here) moves its elements by a share of the learning rate; the
  JAX package's jitted steps against its own eager ones differ by 0.077.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from invesalius3_tpu.models import fastsurfer as fs_jax
from invesalius3_tpu.models import unet2d as u2_jax
from invesalius3_tpu.models import unet3d as u3_jax
from invesalius3_tpu_torch import convert
from chip_smoke import pre_norm_bias
from invesalius3_tpu_torch.models import fastsurfer, layers, train, unet2d, unet3d
from tests.test_torch_unet import jax_variables

torch.set_num_threads(2)

EPS = 1e-6  # the graft entry's BCE epsilon
MODELS = {  # port class, JAX class, carrier, widths, JAX input shape (NHWC / NDHWC)
    "unet3d": (unet3d.Unet3D, u3_jax.Unet3D, convert.unet3d_from_jax,
               {"init_features": 2}, (2, 32, 32, 32, 1)),
    "unet2d": (unet2d.Unet2D, u2_jax.Unet2D, convert.unet2d_from_jax,
               {"features": 4}, (3, 32, 32, 1)),
    "fastsurfer": (fastsurfer.FastSurferCNN, fs_jax.FastSurferCNN, convert.fastsurfer_from_jax,
                   {"num_classes": 6, "filters": 8}, (2, 32, 32, 7)),
}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
CASES = [(k, d) for k in MODELS for d in DTYPES]


def to_port(a: np.ndarray) -> torch.Tensor:
    """Channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def from_port(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def inputs(kind: str):
    port_cls, jax_cls, carry, kw, shape = MODELS[kind]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    out_c = kw.get("num_classes", 1)
    y = (np.random.default_rng(2).random(shape[:-1] + (out_c,)) > 0.5).astype(np.float32)
    return x, y


def bce_jax(probs, y):
    return -jnp.mean(y * jnp.log(probs + EPS) + (1 - y) * jnp.log(1 - probs + EPS))


def probs_of(kind: str, out):
    return jax.nn.sigmoid(out) if kind == "fastsurfer" else out


def train_pass(kind: str, dtype: str) -> dict:
    """One train-mode forward and backward of each package on the same
    variables and batch."""
    port_cls, jax_cls, carry, kw, _ = MODELS[kind]
    tdt, jdt = DTYPES[dtype]
    variables, _ = jax_variables(kind, 5, head_gain=1.0, **kw)
    x, y = inputs(kind)
    model = jax_cls(**kw, dtype=jdt)

    def loss_fn(params, x, y):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        return bce_jax(probs_of(kind, out), y), (out, upd["batch_stats"])

    step = jax.value_and_grad(loss_fn, has_aux=True)
    if dtype == "float32":
        (loss, (out, stats)), grads = jax.jit(step)(variables["params"], x, y)
    else:
        with jax.disable_jit():
            (loss, (out, stats)), grads = step(variables["params"], jnp.asarray(x), jnp.asarray(y))
    port = port_cls(**kw, dtype=tdt)
    port.load_state_dict(carry(variables))
    port.train()
    got = port(to_port(x))
    got_probs = torch.sigmoid(got) if kind == "fastsurfer" else got
    got_loss = train.bce_loss(got_probs, to_port(y))
    got_loss.backward()
    jax_probs = np.asarray(probs_of(kind, out), np.float64)
    return {
        "jax_out": np.asarray(out), "port_out": from_port(got),
        "jax_loss": float(loss), "port_loss": float(got_loss.detach()),
        "graft_loss64": float(-np.mean(y * np.log(jax_probs + EPS)
                                       + (1 - y) * np.log(1 - jax_probs + EPS))),
        "jax_state": carry({"params": variables["params"], "batch_stats": stats}),
        "port_state": port.state_dict(),
        "jax_grads": carry({"params": grads}),
        "port_grads": {k: v.grad.clone() for k, v in port.named_parameters()},
    }


@pytest.fixture(scope="module")
def results():
    """``train_pass`` of a case, computed once in the module."""
    done = {}

    def get(kind: str, dtype: str) -> dict:
        if (kind, dtype) not in done:
            done[kind, dtype] = train_pass(kind, dtype)
        return done[kind, dtype]

    return get


def kept(grads: dict) -> list:
    return [k for k in grads if not pre_norm_bias(k)]


def global_rel(a: dict, b: dict, keys) -> float:
    d = torch.cat([(a[k] - b[k]).reshape(-1) for k in keys])
    w = torch.cat([b[k].reshape(-1) for k in keys])
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(w))


@pytest.mark.parametrize("kind,dtype", CASES)
def test_train_forward_matches_jax(results, kind, dtype):
    r = results(kind, dtype)
    got, want = r["port_out"], r["jax_out"]
    assert got.shape == want.shape and np.isfinite(got).all()
    if kind == "fastsurfer" and dtype == "bfloat16":
        assert np.quantile(np.abs(got - want), 0.99) <= 0.03 * np.abs(want).max()
    elif kind == "fastsurfer":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-2)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("kind,dtype", CASES)
def test_batch_stats_match_jax(results, kind, dtype):
    """The running statistics after one train-mode forward: Flax's
    momentum 0.9 and the biased fast variance of the batch."""
    r = results(kind, dtype)
    keys = [k for k in r["jax_state"] if "running" in k]
    assert keys
    for k in keys:
        got, want = r["port_state"][k].numpy(), r["jax_state"][k].numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            assert np.all(np.abs(got - want) <= 1e-2 * (np.abs(want) + np.abs(want).max())), k


@pytest.mark.parametrize("kind,dtype", CASES)
def test_loss_matches_graft_bce(results, kind, dtype):
    r = results(kind, dtype)
    if dtype == "float32":
        assert abs(r["port_loss"] - r["graft_loss64"]) <= 1e-5 * r["graft_loss64"]
    else:
        assert abs(r["port_loss"] - r["jax_loss"]) <= 1e-2 * r["jax_loss"]


@pytest.mark.parametrize("kind", list(MODELS))
def test_float32_gradients_match_jax(results, kind):
    r = results(kind, "float32")
    got, want = r["port_grads"], r["jax_grads"]
    assert sorted(got) == sorted(want)
    keys = kept(want)
    whole = float(torch.linalg.vector_norm(torch.cat([want[k].reshape(-1) for k in keys])))
    for k in keys:
        err = float(torch.linalg.vector_norm(got[k] - want[k]))
        assert err <= 1e-3 * max(float(torch.linalg.vector_norm(want[k])), 0.01 * whole), k
    for k in set(want) - set(keys):  # zero gradients: rounding noise in both
        assert float(torch.linalg.vector_norm(got[k])) <= 1e-5 * whole, k
        assert float(torch.linalg.vector_norm(want[k])) <= 1e-5 * whole, k


@pytest.mark.parametrize("kind", list(MODELS))
def test_bfloat16_gradients_match_jax(results, kind):
    b16, f32 = results(kind, "bfloat16"), results(kind, "float32")
    keys = kept(f32["jax_grads"])
    jax_spread = global_rel(b16["jax_grads"], f32["jax_grads"], keys)
    port_spread = global_rel(b16["port_grads"], f32["port_grads"], keys)
    assert global_rel(b16["port_grads"], b16["jax_grads"], keys) <= jax_spread
    assert 0.5 <= port_spread / jax_spread <= 2.0


def test_pool_and_maxout_ties_split_gradients_as_jax():
    """FastSurfer's 2x2 max pool, index unpooling and maxout competition on
    inputs with forced ties: the cotangents equal ``jax.grad``'s (half to
    each side of a tie)."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 3, (2, 8, 8, 3)).astype(np.float32)  # many tied windows
    b = rng.integers(0, 3, (2, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)

    def f_jax(a, b):
        pooled, idx = fs_jax.max_pool_with_indices(a)
        return jnp.sum(jnp.maximum(fs_jax.max_unpool(pooled, idx), b) * w)

    want = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = to_port(a).requires_grad_(), to_port(b).requires_grad_()
    pooled, idx = fastsurfer.max_pool_with_indices(at)
    (torch.maximum(fastsurfer.max_unpool(pooled, idx), bt) * to_port(w)).sum().backward()
    for got, ref in zip((at.grad, bt.grad), want):
        np.testing.assert_array_equal(from_port(got), np.asarray(ref))


@pytest.mark.parametrize("kind", list(MODELS))
def test_models_start_in_eval_mode(kind):
    """Flax's ``train`` flag defaults to False: every module of a new model
    is in eval mode, and a forward leaves the running statistics alone."""
    port_cls, _, _, kw, shape = MODELS[kind]
    model = port_cls(**kw)
    assert not any(m.training for m in model.modules())
    model.load_state_dict(layers.init_state(model, torch.Generator().manual_seed(0)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model(to_port(np.zeros(shape, np.float32)))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("kind", ["unet3d", "unet2d"])
def test_eval_after_a_train_step_is_the_eval_forward(kind):
    """``train_step`` leaves the model in eval mode with updated running
    statistics; its eval output is exactly that of a fresh model holding
    the same state, and matches the JAX eval forward on the stepped
    variables (the eval bounds of tests/test_torch_unet.py)."""
    port_cls, jax_cls, carry, kw, _ = MODELS[kind]
    variables, _ = jax_variables(kind, 5, head_gain=1.0, **kw)
    x, y = inputs(kind)
    model = port_cls(**kw, dtype=torch.float32)
    model.load_state_dict(carry(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = train.train_step(model, train.adam(model.parameters()), to_port(x), to_port(y))
    assert np.isfinite(float(loss)) and not model.training
    state = model.state_dict()
    for k in state:
        if k.endswith(("running_mean", "running_var", "weight")):
            assert not torch.equal(state[k], before[k]), k
    assert all(int(v) == 1 for k, v in state.items() if k.endswith("num_batches_tracked"))
    fresh = port_cls(**kw, dtype=torch.float32)
    fresh.load_state_dict(state)
    xt = to_port(x)
    with torch.no_grad():
        got = model(xt)
        assert torch.equal(got, fresh(xt))
    back = {"unet3d": u3_jax, "unet2d": u2_jax}[kind].convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items() if not k.endswith("num_batches_tracked")})
    want = np.asarray(jax.jit(jax_cls(**kw, dtype=jnp.float32).apply)(back, jnp.asarray(x)))
    np.testing.assert_allclose(from_port(got), want, atol=2e-3, rtol=1e-2)


def _jax_unet3d_step(model, tx):
    @jax.jit
    def step(params, stats, opt_state, x, y):
        def loss_fn(p):
            probs, upd = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     mutable=["batch_stats"])
            return bce_jax(probs, y), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, grads, updates

    return step


def _batch(i: int):
    x = np.random.default_rng(10 + i).normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    y = (np.random.default_rng(20 + i).random((2, 32, 32, 32, 1)) > 0.5).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def jax_run():
    """Five JAX training steps of the float32 ``Unet3D`` on five seeded
    batches: the variables, optax state, loss, gradients and updates after
    each."""
    kw = MODELS["unet3d"][3]
    variables, _ = jax_variables("unet3d", 5, head_gain=1.0, **kw)
    tx = optax.adam(1e-3)
    step = _jax_unet3d_step(u3_jax.Unet3D(**kw), tx)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    out = [{"params": params, "stats": stats, "opt_state": opt_state}]
    for i in range(5):
        params, stats, new_state, loss, grads, updates = step(params, stats, opt_state,
                                                              *_batch(i))
        out[-1].update(loss=float(loss), grads=grads, updates=updates)
        opt_state = new_state
        out.append({"params": params, "stats": stats, "opt_state": opt_state})
    return out


def _port_at(run: dict):
    """A float32 port ``Unet3D`` and its Adam, carried from a JAX state."""
    model = unet3d.Unet3D(**MODELS["unet3d"][3])
    model.load_state_dict(convert.unet3d_from_jax({"params": run["params"],
                                                  "batch_stats": run["stats"]}))
    opt = train.adam(model.parameters())
    opt.load_state_dict(convert.adam_state_from_jax(run["opt_state"], model))
    return model, opt


@pytest.mark.parametrize("at", [0, 2])
def test_adam_update_matches_optax(jax_run, at):
    """The port's Adam step on the JAX gradients: fresh (count 0) and from
    the state after two JAX steps (count 2, non-zero moments)."""
    run = jax_run[at]
    model, opt = _port_at(run)
    assert opt.count == at
    grads = convert.unet3d_from_jax({"params": run["grads"]})
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    for k, v in model.named_parameters():
        v.grad = grads[k].clone()
    opt.step()
    want = convert.unet3d_from_jax({"params": run["updates"]})
    for k, v in model.named_parameters():
        np.testing.assert_allclose((v.detach() - before[k]).numpy(), want[k].numpy(),
                                   atol=1e-7, rtol=0, err_msg=k)
    state = convert.adam_state_from_jax(jax_run[at + 1]["opt_state"], model)
    assert opt.count == state["count"] == at + 1
    for got, ref in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-9, rtol=1e-6)


def test_three_steps_from_a_carried_adam_state(jax_run):
    model, opt = _port_at(jax_run[2])
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    for i in range(2, 5):
        loss = train.train_step(model, opt, *(to_port(a) for a in _batch(i)))
        assert abs(float(loss) - jax_run[i]["loss"]) <= 1e-4 * jax_run[i]["loss"]
    end = convert.unet3d_from_jax({"params": jax_run[5]["params"],
                                   "batch_stats": jax_run[5]["stats"]})
    begin = convert.unet3d_from_jax({"params": jax_run[2]["params"],
                                     "batch_stats": jax_run[2]["stats"]})
    assert opt.count == 5
    state = model.state_dict()
    for k, v in state.items():
        if "running" in k:
            assert torch.all((v - end[k]).abs() <= 1e-2 * (end[k].abs() + end[k].abs().max())), k
    for k, v in model.named_parameters():
        if not pre_norm_bias(k):
            change, want = v.detach() - start[k], end[k] - begin[k]
            assert torch.linalg.vector_norm(change - want) <= 0.15 * torch.linalg.vector_norm(
                want), k


@pytest.mark.parametrize("kind", list(MODELS))
def test_adam_state_from_jax_follows_the_parameters(kind):
    port_cls, jax_cls, carry, kw, _ = MODELS[kind]
    variables, model = jax_variables(kind, 6, **kw)
    opt_state = optax.adam(1e-3).init(variables["params"])
    opt_state = (opt_state[0]._replace(
        count=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda a: a + 1.0, variables["params"]),
        nu=jax.tree.map(lambda a: a * a, variables["params"])),) + tuple(opt_state[1:])
    state = convert.adam_state_from_jax(opt_state, model)
    params = carry({"params": variables["params"]})
    names = [k for k, _ in model.named_parameters()]
    assert state["count"] == 7 and len(state["mu"]) == len(names) == len(params)
    for k, mu, nu in zip(names, state["mu"], state["nu"]):
        assert torch.equal(mu, params[k] + 1.0) and torch.equal(nu, params[k] * params[k]), k
    opt = train.adam(model.parameters())
    opt.load_state_dict(state)
    assert opt.count == 7 and all(torch.equal(a, b) for a, b in zip(opt.mu, state["mu"]))


def test_train_step_restores_mode_and_groups():
    model = unet2d.Unet2D(features=2)
    model.load_state_dict(layers.init_state(model, torch.Generator().manual_seed(0)))
    x, y = inputs("unet2d")
    for mode in (True, False):
        model.train(mode)
        train.train_step(model, train.adam(model.parameters()), to_port(x), to_port(y))
        assert all(m.training == mode for m in model.modules())
        assert all(m.group is None for m in model.modules() if isinstance(m, layers.BatchNorm))
