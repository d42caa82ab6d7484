"""The port's segmentation models and weight readers against the JAX
package's, on the CPU: ``Unet3D``, ``Unet2D`` and ``FastSurferCNN`` on the
same seeded inputs with the Flax variables carried across by
``convert.*_from_jax``; every carrier the exact inverse of the JAX
``convert_torch_state_dict``; the reference torch ``Unet3D``'s published
key names; the checkpoint forms (eager, wrapped, pickled module,
TorchScript, ONNX) read to one state dict; the ONNX writer's bytes; the
pooling indices with forced ties.

Tolerances (measured maxima in the comments):
- weight round trips, checkpoint reads, ONNX bytes, pooling: equal;
- float32 models: ``Unet3D`` / ``Unet2D`` probabilities within atol 2e-3,
  rtol 1e-2 (tests/test_unet.py:97), FastSurfer logits within 2e-4
  (tests/test_fastsurfer.py:103);
- bfloat16 models: probabilities within atol 2e-2; FastSurfer logits within
  3% of their largest magnitude (a one-ulp bfloat16 flip in a conv output
  travels through 27 layers).
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from invesalius3_tpu.models import fastsurfer as fs_jax
from invesalius3_tpu.models import onnx_convert as onnx_jax
from invesalius3_tpu.models import unet2d as u2_jax
from invesalius3_tpu.models import unet3d as u3_jax
from invesalius3_tpu_torch import convert
from invesalius3_tpu_torch.models import fastsurfer, onnx_convert, torch_convert, unet2d, unet3d

torch.set_num_threads(2)


def random_state(module: tnn.Module, seed: int, head_gain: float = 4.0) -> dict:
    """A seeded numpy state dict for ``module``: kernels with variance
    1/fan_in (the head's times ``head_gain``, so probabilities spread),
    batch norms with non-trivial scale, bias, mean and var."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            a = rng.normal(0.0, 0.2, shape)
        elif "norm" in k or ".bn" in k:
            a = rng.uniform(0.7, 1.3, shape) if k.endswith("weight") else rng.normal(0, 0.1, shape)
        elif "prelu" in k:
            a = rng.uniform(0.1, 0.4, shape)
        elif k.endswith("bias"):
            a = rng.normal(0.0, 0.05, shape)
        else:
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
            if k.split(".")[0] in ("conv", "classifier"):
                a = a * head_gain
        out[k] = a.astype(np.float32)
    return out


def jax_variables(kind: str, seed: int = 0, head_gain: float = 4.0, **kw):
    """(JAX variables, the port's module) for a model of ``kind``; the
    variables come from a seeded numpy state through the JAX package's own
    converter."""
    m, to_jax = {"unet3d": (unet3d.Unet3D, u3_jax.convert_torch_state_dict),
                 "unet2d": (unet2d.Unet2D, u2_jax.convert_torch_state_dict),
                 "fastsurfer": (fastsurfer.FastSurferCNN, fs_jax.convert_torch_state_dict)}[kind]
    m = m(**kw)
    return to_jax(random_state(m, seed, head_gain)), m


def _leaves_equal(a, b) -> bool:
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    return ta == tb and all(
        np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y)
        for x, y in zip(la, lb))


CARRIERS = {
    "unet3d": (convert.unet3d_from_jax, u3_jax.convert_torch_state_dict,
               {"init_features": 4}),
    "unet2d": (convert.unet2d_from_jax, u2_jax.convert_torch_state_dict, {"features": 4}),
    "fastsurfer": (convert.fastsurfer_from_jax, fs_jax.convert_torch_state_dict,
                   {"num_classes": 5, "filters": 4}),
}


@pytest.mark.parametrize("kind", sorted(CARRIERS))
def test_carrier_round_trips_bit_for_bit(kind):
    carry, back, kw = CARRIERS[kind]
    variables, module = jax_variables(kind, 1, **kw)
    state = carry(variables)
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in state.values())
    module.load_state_dict(state, strict=True)  # every key, no extra
    assert _leaves_equal(back(state), variables)


def _reference_unet3d(f: int) -> tnn.Module:
    """The reference torch ``Unet3D`` (reference deep_learning/model.py:9-114,
    rebuilt in tests/test_unet.py): blocks are Sequentials of named layers,
    and every decoder's layers are named dec4_*."""

    def block(cin, feats, name):
        return tnn.Sequential(OrderedDict((
            (f"{name}_conv1", tnn.Conv3d(cin, feats, 5, padding=2)),
            (f"{name}_norm1", tnn.BatchNorm3d(feats)), (f"{name}_relu1", tnn.ReLU()),
            (f"{name}_conv2", tnn.Conv3d(feats, feats, 5, padding=2)),
            (f"{name}_norm2", tnn.BatchNorm3d(feats)), (f"{name}_relu2", tnn.ReLU()))))

    class Reference(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder1, self.encoder2 = block(1, f, "enc1"), block(f, f * 2, "enc2")
            self.encoder3, self.encoder4 = block(f * 2, f * 4, "enc3"), block(f * 4, f * 8, "enc4")
            self.bottleneck = block(f * 8, f * 16, "bottleneck")
            for i, c in ((4, f * 8), (3, f * 4), (2, f * 2), (1, f)):
                setattr(self, f"upconv{i}", tnn.ConvTranspose3d(c * 2, c, 4, 2, 1))
                setattr(self, f"decoder{i}", block(c * 2, c, "dec4"))
            self.conv = tnn.Conv3d(f, 1, 1)

        def forward(self, x):
            skips = []
            for i in (1, 2, 3, 4):
                x = getattr(self, f"encoder{i}")(x)
                skips.append(x)
                x = tnn.functional.max_pool3d(x, 2)
            x = self.bottleneck(x)
            for i in (4, 3, 2, 1):
                x = getattr(self, f"decoder{i}")(
                    torch.cat((getattr(self, f"upconv{i}")(x), skips[i - 1]), 1))
            return torch.sigmoid(self.conv(x))

    return Reference()


def test_unet3d_loads_the_reference_state_dict_strictly():
    ref = _reference_unet3d(4).eval()
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in random_state(ref, 3).items()},
                        strict=False)
    port = unet3d.Unet3D(init_features=4)
    port.load_state_dict(ref.state_dict(), strict=True)  # num_batches_tracked too
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    for i in (1, 2, 3, 4):
        assert f"decoder{i}.dec4_conv1.weight" in port.state_dict()
        assert f"decoder{i}.dec4_norm2.running_var" in port.state_dict()
    assert "encoder2.enc2_norm1.running_mean" in port.state_dict()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 1, 16, 16, 16))
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(port.eval()(x).numpy(), ref(x).numpy(), atol=2e-6)


def _unet3d_pair(dtype):
    variables, port = jax_variables("unet3d", 5, init_features=4)
    port = unet3d.Unet3D(init_features=4, dtype=dtype)
    port.load_state_dict(convert.unet3d_from_jax(variables))
    model = u3_jax.Unet3D(init_features=4, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                          else jnp.float32)
    return variables, model, port.eval()


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-3, 1e-2),
                                             (torch.bfloat16, 2e-2, 0.0)])
def test_unet3d_matches_jax(dtype, atol, rtol):
    """float32: max |diff| 6e-7; bfloat16: 6e-3."""
    variables, model, port = _unet3d_pair(dtype)
    x = np.random.default_rng(6).normal(size=(2, 16, 16, 16)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)[..., None]))[..., 0]
    with torch.no_grad():
        got = port(torch.from_numpy(x)[:, None])[:, 0].numpy()
    assert got.dtype == np.float32 and want.std() > 0.05  # spread, not all 0.5
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-3, 1e-2),
                                             (torch.bfloat16, 2e-2, 0.0)])
def test_unet2d_matches_jax(dtype, atol, rtol):
    """float32: max |diff| 2.4e-7; bfloat16: 3.2e-3."""
    variables, _ = jax_variables("unet2d", 7, features=8)
    port = unet2d.Unet2D(features=8, dtype=dtype).eval()
    port.load_state_dict(convert.unet2d_from_jax(variables))
    model = u2_jax.Unet2D(features=8, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                          else jnp.float32)
    x = (np.random.default_rng(8).random((3, 32, 32)) > 0.5).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)[..., None]))[..., 0]
    with torch.no_grad():
        got = port(torch.from_numpy(x)[:, None])[:, 0].numpy()
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fastsurfer_cnn_matches_jax(dtype):
    """Against the Flax model applied eagerly, as tests/test_fastsurfer.py
    applies it: float32 logits max |diff| 9e-6 (bound 2e-4); bfloat16 0.5%
    of the largest logit (bound 3%).  Jitted, XLA on the CPU fuses the batch
    norms' multiply-add into FMAs, and in bfloat16 the one-ulp changes
    move 0.3% of the logits by more (a 2x2 pooling index flips between
    near-tied values): the segmenter tests bound the labels instead."""
    variables, _ = jax_variables("fastsurfer", 9, num_classes=6, filters=8)
    port = fastsurfer.FastSurferCNN(num_classes=6, filters=8, dtype=dtype).eval()
    port.load_state_dict(convert.fastsurfer_from_jax(variables))
    model = fs_jax.FastSurferCNN(num_classes=6, filters=8,
                                 dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    x = np.random.default_rng(10).normal(size=(2, 32, 32, 7)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    atol = 2e-4 if dtype == torch.float32 else 0.03 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_fastsurfer_names_match_the_jax_converter():
    """enc1 has bn0 and no prelu1; every other block has prelu1-3."""
    keys = fastsurfer.FastSurferCNN(num_classes=5, filters=4).state_dict()
    assert "enc1.bn0.running_var" in keys and "enc1.prelu1.weight" not in keys
    assert "dec2.prelu1.weight" in keys and "enc2.bn0.weight" not in keys
    assert keys["bottleneck.prelu3.weight"].shape == (1,)
    assert "classifier.bias" in keys and "enc3.conv2.bias" not in keys


# ---------------------------------------------------------------------------
# checkpoint forms
# ---------------------------------------------------------------------------

def _wrapped(module):
    class WrapModel(tnn.Module):  # the reference's WrapModel, model.py:116-123
        def __init__(self):
            super().__init__()
            self.model = module

        def forward(self, x):
            return self.model(x)

    return WrapModel().eval()


def _write(form, module, path):
    sd = module.state_dict()
    if form == "state_dict":
        torch.save(sd, path)
    elif form == "model_state_dict":
        torch.save({"model_state_dict": {"module." + k: v for k, v in sd.items()},
                    "epoch": 3}, path)
    elif form == "pickled_module":
        torch.save(module, path)
    elif form == "torchscript":
        torch.jit.save(torch.jit.trace(module, torch.zeros(1, 1, 16, 16)), str(path))
    elif form == "torchscript_wrapped":
        torch.jit.save(torch.jit.trace(_wrapped(module), torch.zeros(1, 1, 16, 16)), str(path))
    else:  # "onnx": the JAX package's writer
        onnx_jax.write_onnx(path, {k: v.numpy() for k, v in sd.items()})


FORMS = ["state_dict", "model_state_dict", "pickled_module", "torchscript",
         "torchscript_wrapped", "onnx"]


@pytest.mark.parametrize("form", FORMS)
def test_checkpoint_forms_read_to_one_state_dict(form, tmp_path):
    module = unet2d.Unet2D(features=4).eval()
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            random_state(module, 11).items()}, strict=False)
    path = tmp_path / ("w.onnx" if form == "onnx" else "w.pt")
    _write(form, module, path)
    got = unet2d.load_torch_checkpoint(path)
    want = {k: v.numpy() for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert _leaves_equal(u2_jax.convert_torch_state_dict(got),
                         u2_jax.load_torch_checkpoint(str(path)))
    unet2d.Unet2D(features=4).load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in got.items()}, strict=True)


def test_torchscript_unet3d_reads_to_the_published_names(tmp_path):
    """The mandible checkpoint is a TorchScript archive; its weights read
    back under the reference names, and the scripted module is not run."""
    module = unet3d.Unet3D(init_features=2).eval()
    path = tmp_path / "mandible_jit_ct.pt"
    torch.jit.save(torch.jit.trace(module, torch.zeros(1, 1, 16, 16, 16)), str(path))
    got = unet3d.load_torch_checkpoint(path)
    assert sorted(got) == sorted(k for k in module.state_dict()
                                 if not k.endswith("num_batches_tracked"))
    assert _leaves_equal(u3_jax.load_torch_checkpoint(str(path)),
                         u3_jax.convert_torch_state_dict(got))


def test_strip_wrapper_prefixes_matches_jax():
    from invesalius3_tpu.models import torch_convert as tc_jax

    for state in ({"module.model.a": 1, "module.model.b": 2}, {"net.x": 1, "y": 2},
                  {"model.net.module.w": 3}, {}):
        assert torch_convert.strip_wrapper_prefixes(state) == \
            tc_jax.strip_wrapper_prefixes(state)


def test_onnx_files_of_either_writer_match(tmp_path):
    variables, module = jax_variables("fastsurfer", 12, num_classes=5, filters=4)
    state = {k: v.numpy() for k, v in convert.fastsurfer_from_jax(variables).items()}
    state["enc1.bn0.num_batches_tracked"] = np.array(7, np.int64)
    state["onnx::Conv_123"] = np.arange(3, dtype=np.float16)
    onnx_jax.write_onnx(tmp_path / "jax.onnx", state)
    onnx_convert.write_onnx(tmp_path / "port.onnx", state)
    assert (tmp_path / "jax.onnx").read_bytes() == (tmp_path / "port.onnx").read_bytes()
    got = fastsurfer.load_onnx_checkpoint(tmp_path / "jax.onnx")
    want = onnx_jax.onnx_state_dict(tmp_path / "jax.onnx")
    assert sorted(got) == sorted(want) == sorted(k for k in state if "::" not in k
                                                 and "num_batches" not in k)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert _leaves_equal(fs_jax.load_onnx_checkpoint(tmp_path / "jax.onnx"),
                         fs_jax.convert_torch_state_dict(got))


def test_onnx_reader_data_variants_match_jax():
    """float_data, int64 varints and float16 raw data, as
    tests/test_fastsurfer.py writes them, decode alike."""
    import struct

    def field(num, wire, payload):
        return onnx_jax._varint((num << 3) | wire) + (
            onnx_jax._varint(len(payload)) + payload if wire == 2 else payload)

    v = onnx_jax._varint
    t1 = field(1, 0, v(3)) + field(2, 0, v(1)) + field(8, 2, b"w.f") + field(
        4, 2, struct.pack("<3f", 1.5, -2.25, 3.0))
    t2 = field(1, 0, v(2)) + field(2, 0, v(7)) + field(8, 2, b"w.i") + field(
        7, 2, b"".join(v(x & ((1 << 64) - 1)) for x in (7, -3)))
    t3 = field(1, 0, v(2)) + field(2, 0, v(16)) + field(8, 2, b"w.bf") + field(
        9, 2, np.array([0x3F80, 0xC040], "<u2").tobytes())
    model = field(1, 0, v(8)) + field(7, 2, field(5, 2, t1) + field(5, 2, t2) + field(5, 2, t3))
    got = onnx_convert.parse_onnx_initializers(model)
    want = onnx_jax.parse_onnx_initializers(model)
    assert sorted(got) == sorted(want) == ["w.bf", "w.f", "w.i"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["w.bf"], [1.0, -3.0])


# ---------------------------------------------------------------------------
# FastSurfer's index pooling, ties forced
# ---------------------------------------------------------------------------

def _tied(shape, seed):
    """Values from {0, 0.5, 1}: most 2x2 windows hold a tie for the max."""
    return (np.random.default_rng(seed).integers(0, 3, shape) / 2).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_max_pool_with_indices_takes_the_first_maximum(dtype):
    x = _tied((2, 8, 6, 3), 13).astype(dtype)  # NHWC, the JAX layout
    pooled_j, idx_j = fs_jax.max_pool_with_indices(jnp.asarray(x))
    xt = torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2)
    if dtype != np.float32:
        xt = xt.to(torch.bfloat16)
    pooled, idx = fastsurfer.max_pool_with_indices(xt)
    assert idx.dtype == torch.int8
    np.testing.assert_array_equal(idx.permute(0, 2, 3, 1).numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(pooled.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(pooled_j, np.float32))
    ties = (np.asarray(x, np.float32).reshape(2, 4, 2, 3, 2, 3) ==
            np.asarray(pooled_j, np.float32)[:, :, None, :, None]).sum((2, 4)) > 1
    assert ties.mean() > 0.3  # the test holds many ties


def test_max_unpool_matches_jax():
    x = _tied((2, 4, 5, 3), 14) - 0.5  # negatives: x * 0 gives -0.0, as in JAX
    idx = np.random.default_rng(15).integers(0, 4, (2, 4, 5, 3)).astype(np.int8)
    want = np.asarray(fs_jax.max_unpool(jnp.asarray(x), jnp.asarray(idx)))
    got = fastsurfer.max_unpool(torch.from_numpy(x).permute(0, 3, 1, 2),
                                torch.from_numpy(idx).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
