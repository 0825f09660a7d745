"""Semantic guidance of the random-pose step (the reference's clip_utils role).

Counterpart of enerf_tpu/train/clip_guidance.py.  The provider emits a
random orbit pose every rand_pose batches (data/provider.py); the step
renders its full side x side ray grid and scores the image with
1 - <embed(image), text feature> (train/step.py:train_step_clip), which is
differentiable through the render.

No CLIP weights are in the repository, so `StubEmbedder` is a fixed seeded
random-projection embedder (the image resized to 16 x 16 as
`jax.image.resize(..., "linear")` resizes it, flattened, projected to
`dim`, normalised), and the text feature is its seeded pseudo text
embedding.  The JAX package takes the text feature from the `clip`
package when that imports; the port does not: it has only the stub path
until the `clip` package and its ViT-B/32 weights are in the repository.
The projection and the pseudo text embedding are drawn from
torch.Generators, the JAX package's from threefry, so `loss_clip` is
comparable within a package, not across; `convert.embedder_from_jax`
carries JAX's draws across.
"""

import hashlib
from functools import lru_cache

import numpy as np
import torch

SIZE = 16  # the embedder's image side
SEED = 0  # the projection's generator seed


def clip_available():
    try:
        import clip  # noqa: F401
        return True
    except ImportError:
        return False


@lru_cache(maxsize=None)
def resize_matrix(n_in, n_out, device):
    """[n_out, n_in] f32 weights of jax.image.resize(method="linear") along
    one axis (jax/_src/image/scale.py, compute_weight_mat): a triangle kernel
    at each output's sample point, widened by in/out when shrinking
    (antialias), each output's weights normalised to sum 1, outputs whose
    sample point lies outside the input zeroed; computed in f32 as JAX
    computes it."""
    inv_scale = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(n_out / n_in,
                                                                      dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - (x / kernel_scale).abs(), min=0.0)  # [n_in, n_out]
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T.contiguous().to(device)


def resize_linear(img, size):
    """[H, W, C] -> [size, size, C] as jax.image.resize(img, (size, size, C),
    "linear") gives it; an axis already `size` long is left as it is (JAX
    skips it too)."""
    H, W, _ = img.shape
    if H != size:
        img = torch.einsum("oh,hwc->owc", resize_matrix(H, size, img.device), img)
    if W != size:
        img = torch.einsum("ow,hwc->hoc", resize_matrix(W, size, img.device), img)
    return img


class StubEmbedder:
    """Deterministic differentiable image embedder: the image resized to
    16 x 16, flattened, times a fixed projection to `dim` (N(0, 1) /
    sqrt(16 * 16 * channels), drawn from torch.Generator SEED), normalised.
    `proj` [16 * 16 * channels, dim] replaces the drawn projection
    (convert.embedder_from_jax)."""

    def __init__(self, dim=64, channels=3, device="cpu", proj=None):
        self.dim, self.channels = dim, channels
        k = SIZE * SIZE * channels
        if proj is None:
            gen = torch.Generator().manual_seed(SEED)
            proj = torch.randn(k, dim, generator=gen) / np.sqrt(k)
        self.proj = torch.as_tensor(proj, dtype=torch.float32).to(device)
        if self.proj.shape != (k, dim):
            raise ValueError(f"StubEmbedder: proj must be [{k}, {dim}], got "
                             f"{tuple(self.proj.shape)}")

    def __call__(self, image_hwc):
        """[H, W, C] in [0, 1] -> [dim] unit embedding (differentiable)."""
        x = image_hwc
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], self.channels)
        z = resize_linear(x, SIZE).reshape(-1) @ self.proj
        return z / (torch.linalg.vector_norm(z) + 1e-8)

    def embed_text(self, text):
        """Seeded pseudo text embedding (stable per string, from its sha256)."""
        seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "little")
        z = torch.randn(self.dim, generator=torch.Generator().manual_seed(seed))
        return (z / (torch.linalg.vector_norm(z) + 1e-8)).to(self.proj.device)


class CLIPGuidance:
    """(embedder, text feature) pair of the rand-pose guidance loss."""

    def __init__(self, text, embedder=None):
        self.embedder = embedder or StubEmbedder()
        self.text_feat = self.embedder.embed_text(text)

    def loss(self, image_hwc):
        """1 - cos(embed(image), text): differentiable through the render."""
        return 1.0 - (self.embedder(image_hwc) * self.text_feat).sum()


class CLIPLoss:
    """The JAX package's scoring shim: raises ImportError without the `clip`
    package (CLIPGuidance is the training path).  With it, real-CLIP scoring
    is not ported: it raises NotImplementedError."""

    def __init__(self, text, device="cpu"):
        if not clip_available():
            raise ImportError("CLIPLoss (torch scoring path) needs the `clip` package; "
                              "use CLIPGuidance for the wired training path")
        raise NotImplementedError("enerf_torch scores with the stub embedder only "
                                  "(CLIPGuidance); real-CLIP scoring is not ported")
