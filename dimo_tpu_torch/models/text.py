"""Text conditioning: BERT sentence embeddings + MLP latent projector.

Counterpart of `dimo_tpu/models/text.py` (the reference's
`src/text_embs.py`): pooled bert-base-cased embeddings (max 25 tokens)
projected 768 -> latent_dim by a single Linear (`MLPEncoder` with
num_layers=1). BERT runs on the host through transformers, imported by
`get_motion_embs`; a precomputed embedding can be passed instead when the
BERT weights are not cached locally. The projector's weights live on the
device of the renders.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dimo_tpu_torch.utils.general import resolve_device


def get_motion_embs(descriptions: list[str], max_word_len: int = 25) -> np.ndarray:
    """Pooled BERT embeddings (B, 768). Requires bert-base-cased weights
    available to transformers (cached or local)."""
    from transformers import AutoModel, AutoTokenizer

    tz = AutoTokenizer.from_pretrained("bert-base-cased")
    model = AutoModel.from_pretrained("bert-base-cased")
    tokens = tz(text=descriptions, add_special_tokens=True,
                max_length=max_word_len, padding="max_length",
                return_attention_mask=True, return_tensors="pt")
    with torch.no_grad():
        out = model(tokens["input_ids"], tokens["attention_mask"])
    return out["pooler_output"].numpy()


class MLPProjector:
    """768 -> latent_dim linear projector (weights from the reference's
    mlp_encoder.pth or a native .npz)."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        self.weight = weight      # (768, latent_dim)
        self.bias = bias          # (latent_dim,)

    def __call__(self, emb: torch.Tensor) -> torch.Tensor:
        return emb @ self.weight + self.bias


def load_mlp_projector(path: str, latent_dim: int = 32,
                       device="cuda") -> MLPProjector:
    """Load the projector; .npz native, .pth the reference's state dict
    (`projection.0.weight` is (latent, 768), stored transposed here). The
    reference repo does NOT include the projector's training script: with
    no weights at `path`, a fixed random projection from
    `np.random.RandomState(0)` is used, the reference's fallback."""
    dev = resolve_device(device)

    def on_dev(w, b):
        return MLPProjector(
            torch.as_tensor(np.ascontiguousarray(w, np.float32), device=dev),
            torch.as_tensor(np.ascontiguousarray(b, np.float32), device=dev))

    if path and os.path.exists(path):
        if path.endswith(".npz"):
            with np.load(path) as z:
                return on_dev(z["weight"], z["bias"])
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        w = sd["projection.0.weight"].detach().numpy()   # (latent, 768)
        b = sd["projection.0.bias"].detach().numpy()
        return on_dev(w.T, b)
    print(f"[WARN] no MLP projector weights at {path!r}; using a seeded "
          "random projection")
    rng = np.random.RandomState(0)
    w = (rng.randn(768, latent_dim) / np.sqrt(768)).astype(np.float32)
    return on_dev(w, np.zeros((latent_dim,), np.float32))
