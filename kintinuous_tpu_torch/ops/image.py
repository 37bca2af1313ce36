"""Model-view renders for the viewer's panes (port of
kintinuous_tpu/ops/image.py, the reference's image_generator.cu):

  generate_image <- generateImage: the Phong-shaded normal render of a
                    raycast prediction, coloured by the model (color) or
                    by the fusion weight (heat)
  generate_depth <- generateDepth: a grayscale depth render

On the input's device; the result is uint8, each value truncated as
the JAX package's astype(uint8) does.
"""

from __future__ import annotations

from typing import Optional

import torch


def generate_image(vmap: torch.Tensor, nmap: torch.Tensor,
                   color: Optional[torch.Tensor] = None,
                   weight: Optional[torch.Tensor] = None,
                   light_dir=(0.3, -0.4, -0.85), mode: str = "shaded") -> torch.Tensor:
    """(3,H,W) vertex and normal maps (NaN = miss), optional (3,H,W)
    colour 0..255 and (H,W) fusion weights -> (H,W,3) uint8; mode is
    shaded, color or heat."""
    valid = torch.isfinite(nmap).all(dim=0)
    l = torch.tensor(light_dir, dtype=torch.float32, device=nmap.device)
    l = l / torch.linalg.norm(l)
    ndotl = torch.abs(nmap[0] * l[0] + nmap[1] * l[1] + nmap[2] * l[2])
    shade = torch.where(valid, 0.15 + 0.85 * ndotl, 0.0)
    if mode == "color" and color is not None:
        img = torch.movedim(color, 0, -1) * (0.3 + 0.7 * shade[..., None])
    elif mode == "heat" and weight is not None:
        # weight 0..128 -> a blue to red ramp (the reference's heat colouring)
        t = torch.clamp(weight / 128.0, 0.0, 1.0)
        img = torch.stack([t, 0.2 + 0.3 * t, 1.0 - t], dim=-1) * 255.0 * shade[..., None]
    else:
        img = torch.stack([shade] * 3, dim=-1) * 255.0
    return torch.clamp(torch.nan_to_num(img), 0, 255).to(torch.uint8)


def generate_depth(depth: torch.Tensor, max_depth: float = 6.0) -> torch.Tensor:
    """(H,W) depth in metres -> (H,W,3) uint8 grayscale, near bright."""
    t = torch.clamp(depth / max_depth, 0.0, 1.0)
    g = torch.where(depth > 0, 255.0 * (1.0 - t), 0.0)
    return torch.stack([g] * 3, dim=-1).to(torch.uint8)
