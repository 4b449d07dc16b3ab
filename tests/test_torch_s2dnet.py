"""Port parity: the PyTorch S2DNet against the JAX package's Flax S2DNet.

``params_from_flax`` carries the JAX model's variables across (with
randomized BatchNorm statistics, so a wrong BN mapping cannot pass as the
identity); the forward passes on a 64x48 image agree to atol 1e-4 (float32
on both sides, convolutions summed in different orders).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pixsfm_tpu.features.models.s2dnet import S2DNet as JaxS2DNet
from pixsfm_tpu_torch.features.models.s2dnet import S2DNet, params_from_flax

# torchvision vgg16().features child index of each conv layer: the key
# layout of the reference checkpoint (encoder.{idx}.*)
VGG16_FEATURES_CONV_INDICES = {
    "conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14, "conv4_1": 17,
    "conv4_2": 19, "conv4_3": 21, "conv5_1": 24, "conv5_2": 26,
    "conv5_3": 28,
}


def test_forward_matches_flax_with_converted_params():
    rng = np.random.default_rng(0)
    jm = JaxS2DNet({"num_layers": 1})
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(jm.variables))
    bn_p = variables["params"]["adap0_bn"]
    bn_s = variables["batch_stats"]["adap0_bn"]
    bn_p["scale"] = rng.uniform(0.5, 1.5, bn_p["scale"].shape).astype(
        np.float32)
    bn_p["bias"] = rng.normal(0, 0.1, bn_p["bias"].shape).astype(np.float32)
    bn_s["mean"] = rng.normal(0, 0.1, bn_s["mean"].shape).astype(np.float32)
    bn_s["var"] = rng.uniform(0.5, 2.0, bn_s["var"].shape).astype(np.float32)
    jm.variables = flax.core.freeze(jax.tree.map(jnp.asarray, variables))

    tm = S2DNet({"num_layers": 1}, device="cpu")
    tm.load_state_dict(params_from_flax(variables))

    image = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    ref = np.asarray(jm(jnp.asarray(image[None]))[0])[0]          # [h, w, C]
    with torch.no_grad():
        out = tm(torch.from_numpy(image).permute(2, 0, 1)[None])[0][0]
    assert out.shape == (128, 48, 64)
    np.testing.assert_allclose(out.permute(1, 2, 0).numpy(), ref, atol=1e-4)


def test_state_dict_uses_reference_checkpoint_keys():
    tm = S2DNet({"num_layers": 3}, device="cpu")
    keys = set(tm.state_dict())
    for name, idx in VGG16_FEATURES_CONV_INDICES.items():
        assert f"encoder.{idx}.weight" in keys, name
    for i in range(3):
        pre = f"adaptation_layers.adap_layer_{i}"
        for k in ("0.weight", "2.weight", "3.weight", "3.running_mean",
                  "3.running_var"):
            assert f"{pre}.{k}" in keys
    assert tm.scales == [1, 4, 16] and tm.output_dims == [128] * 3


def test_random_init_is_deterministic():
    a = S2DNet({"num_layers": 1}, device="cpu", seed=3).state_dict()
    b = S2DNet({"num_layers": 1}, device="cpu", seed=3).state_dict()
    c = S2DNet({"num_layers": 1}, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.0.weight"], c["encoder.0.weight"])
