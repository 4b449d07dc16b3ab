#!/usr/bin/env python3
"""How far K1's L2-normalized outputs at 1-3 channels sit from the plain
version and from the truth, for the narrow kernel and for the general one,
on maps of three kinds (one NVIDIA GPU):

    python3 scripts/k1_l2_conditioning.py

L2 normalization divides by the norm ||f|| of the interpolated vector, so
its derivatives grow as 1 / ||f||, and two float32 sums in different orders
part by ~1e-7 / ||f||^2. At 1-2 channels of zero-mean or dark values ||f||
comes near 0. Each line: channels, maps, storage, the smallest ||f|| of the
queries, the largest |narrow - plain|, |general - plain| and |narrow -
general| over (f, df/dr, df/dc) on 1501 queries over 40 16x16 patches, and
the largest error of each of the three (narrow, general, the float32 plain
version) against the plain version computed in float64, which tells which
side of a disagreement is nearer the truth.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    from pixsfm_tpu_torch.ops import interpolate_cuda as ic

    if not torch.cuda.is_available():
        print("k1_l2_conditioning: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    H = W = 16
    n, n_patches = 1501, 40

    def err(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))

    for C in (1, 2, 3):
        for maps, lo, normal in (("N(0, 1)", None, True),
                                 ("[0, 1)", 0.0, False),
                                 ("[0.25, 1)", 0.25, False)):
            for dtype in (torch.float32, torch.bfloat16):
                for seed in (20, 21, 22):
                    gen = torch.Generator(device=dev).manual_seed(seed)
                    numel = n_patches * H * W * C
                    if normal:
                        buf = torch.randn(numel, generator=gen, device=dev)
                    else:
                        buf = lo + (1 - lo) * torch.rand(
                            numel, generator=gen, device=dev)
                    rows = buf.view(n_patches * H, W, C).to(dtype)
                    rb = torch.randint(0, n_patches, (n,), generator=gen,
                                       device=dev) * H
                    r = torch.rand(n, generator=gen, device=dev) * (H + 2.) \
                        - 1.5
                    c = torch.rand(n, generator=gen, device=dev) * (W + 2.) \
                        - 1.5
                    args = (rows, H, W, C, rb, r, c, True)
                    plain = ic.interpolate_rows_plain(*args)
                    narrow = ic.interpolate_rows(*args, variant="narrow")
                    general = ic.interpolate_rows(*args, variant="general")
                    exact = ic.interpolate_rows_plain(*args,
                                                      dtype=torch.float64)
                    f = ic.interpolate_rows_plain(rows, H, W, C, rb, r, c,
                                                  False)[0]
                    norm = float(torch.linalg.vector_norm(f, dim=-1).min())
                    print(f"C={C} maps {maps} {str(dtype)[6:]} seed {seed}: "
                          f"min ||f|| {norm:.3e}; |narrow - plain| "
                          f"{err(narrow, plain):.3e}, |general - plain| "
                          f"{err(general, plain):.3e}, |narrow - general| "
                          f"{err(narrow, general):.3e}; against float64: "
                          f"narrow {err(narrow, exact):.3e}, general "
                          f"{err(general, exact):.3e}, plain f32 "
                          f"{err(plain, exact):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
