"""S2DNet's weights (``num_layers: 1``) from the seed, made on the device.

One ``torch.randn`` call on a generator seeded with the run's seed fills
every convolution kernel (LeCun-normal: scaled by 1 / sqrt(fan-in)); biases
are zero and BatchNorm is the identity, as the program's own random init.
The names are the program's (torchvision's ``vgg16().features`` indices and
the adaptation head's), so the same dict loads into the program's model and
feeds the plain reference.
"""

from __future__ import annotations

from typing import Dict

import torch

# (name, shape) of every convolution kernel, in draw order
KERNELS = [
    ("encoder.0", (64, 3, 3, 3)),
    ("encoder.2", (64, 64, 3, 3)),
    ("adaptation_layers.adap_layer_0.0", (64, 64, 1, 1)),
    ("adaptation_layers.adap_layer_0.2", (128, 64, 5, 5)),
]
BATCHNORM = "adaptation_layers.adap_layer_0.3"
CHANNELS = 128


def s2dnet_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [int(torch.Size(s).numel()) for _, s in KERNELS]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape), part in zip(KERNELS, torch.split(flat, sizes)):
        fan_in = shape[1] * shape[2] * shape[3]
        out[f"{name}.weight"] = part.view(shape) / fan_in ** 0.5
        out[f"{name}.bias"] = torch.zeros(shape[0], device=device)
    out[f"{BATCHNORM}.weight"] = torch.ones(CHANNELS, device=device)
    out[f"{BATCHNORM}.bias"] = torch.zeros(CHANNELS, device=device)
    out[f"{BATCHNORM}.running_mean"] = torch.zeros(CHANNELS, device=device)
    out[f"{BATCHNORM}.running_var"] = torch.ones(CHANNELS, device=device)
    return out
