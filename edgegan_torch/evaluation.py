"""Quality evaluation: classifier-FID and reconstruction metrics (the JAX
package's evaluation.py:1-215; the Frechet math is a copy, the port
imports nothing of the JAX package).

    fid = ||mu_r - mu_f||^2 + Tr(S_r + S_f - 2 (S_r S_f)^{1/2})

Feature extractors map NHWC float32 images in [-1, 1] to [n, d] numpy
features:
- `pinned_extractor(npz_path, device)`: the classifier trained once and
  kept in the tree (docs/fid_extractor.npz, 14 classes at 64x128, with a
  `.json` sidecar); every run scored through it lies in one feature
  space, so its numbers compare across runs;
- `classifier_extractor(classifier, device)`: the classifier of a run's own
  checkpoint, for tracking within one run;
- `inception_extractor(weights_path, device)`: torchvision InceptionV3
  pool3 features from a local state dict (paper-comparable FID; neither
  torchvision nor the weights come with the repository).

The classifier extractors return the classifier's 768-d spatial mean of
its last PReLU'd MRU state (`Classifier.forward(..., return_features=
True)`), computed in float32 with TF32 off. Classifier-FID is for
relative tracking only, not comparable to published InceptionV3 FID.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .bridge import load_classifier, unflatten_npz
from .core.config import Config
from .infer import exact_f32
from .models.classifier import Classifier
from .ops.resize import resize


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (the FID formula). A
    product whose square root is not finite is retried with `eps` on the
    diagonals; the square root's imaginary part is dropped."""
    import scipy.linalg

    def _sqrtm(m):
        try:
            out = scipy.linalg.sqrtm(m, disp=False)
        except TypeError:  # newer scipy has no `disp` and prints nothing
            out = scipy.linalg.sqrtm(m)
        return out[0] if isinstance(out, tuple) else out  # scipy API drift

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(real_features, fake_features) -> float:
    mu_r, s_r = compute_statistics(real_features)
    mu_f, s_f = compute_statistics(fake_features)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def compute_fid(real_images: np.ndarray, fake_images: np.ndarray,
                extractor: Callable[[np.ndarray], np.ndarray],
                batch_size: int = 64) -> float:
    """images: [N, H, W, 3] in [-1, 1]; `extractor` maps a batch to
    [n, d]."""
    def run(images):
        feats = []
        for i in range(0, len(images), batch_size):
            feats.append(np.asarray(extractor(images[i:i + batch_size])))
        return np.concatenate(feats, axis=0)
    return fid_from_features(run(real_images), run(fake_images))


def inception_extractor(weights_path: Optional[str] = None,
                        device: str = 'cuda'):
    """torchvision InceptionV3 pool3 (2048-d) feature extractor.

    `weights_path`: a local state-dict file (pth), required for
    paper-comparable FID; None raises."""
    if weights_path is None:
        raise ValueError(
            'FID needs the InceptionV3 weights. Download '
            'inception_v3_google-*.pth where you have network access '
            'and pass weights_path.')
    import torchvision  # not a dependency of the port; needs the weights
    model = torchvision.models.inception_v3(weights=None, aux_logits=True,
                                            init_weights=False)
    model.load_state_dict(torch.load(weights_path, map_location=device))
    model.fc = torch.nn.Identity()
    model.eval().to(device)
    mean = torch.tensor([0.485, 0.456, 0.406], device=device)
    std = torch.tensor([0.229, 0.224, 0.225], device=device)

    @torch.no_grad()
    def extract(images: np.ndarray) -> np.ndarray:
        # [-1, 1] NHWC -> 299x299, ImageNet normalisation
        x = torch.from_numpy(np.asarray(images, np.float32))
        x = x.permute(0, 3, 1, 2).to(device)
        x = torch.nn.functional.interpolate(
            x, size=(299, 299), mode='bilinear', align_corners=False)
        x = (x + 1.0) / 2.0
        x = (x - mean[None, :, None, None]) / std[None, :, None, None]
        return model(x).cpu().numpy()

    return extract


def _features(classifier: Classifier, device,
              native_hw: Optional[Tuple[int, int]] = None):
    """images -> the classifier's features, on `device` in float32; with
    `native_hw`, inputs of another size are first resized to it (bicubic,
    `ops/resize.py`)."""
    exact_f32()
    classifier = classifier.to(device).eval()

    @torch.no_grad()
    def extract(images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
        x = x.permute(0, 3, 1, 2)
        if native_hw is not None and tuple(x.shape[2:]) != native_hw:
            x = resize(x, native_hw)
        return classifier(x, return_features=True)[3].cpu().numpy()

    return extract


def classifier_extractor(classifier: Classifier, device='cuda'):
    """The in-run extractor: a run's classifier `D2` whose weights came
    from a checkpoint (`bridge.load_classifier`). Its numbers track one
    run's checkpoints; they do not compare across runs."""
    return _features(classifier, torch.device(device))


def pinned_extractor(npz_path: str, device='cuda'):
    """The cross-run extractor: the classifier stored at `npz_path`
    (float16 leaves `params/...` and `aux/spectral/.../u`, without a
    'D2/' level) with its configuration in `<npz_path>.json`. Loaded in
    float32; inputs whose size is not the extractor's native photo half
    (output_height, output_width / 2) are resized to it, so that the
    hires halves (128x128) score in the same feature space."""
    if not os.path.exists(npz_path):
        raise FileNotFoundError(
            f'{npz_path} not found: it is trained once by '
            'scripts/train_fid_extractor.py')
    with open(npz_path + '.json') as f:
        meta = json.load(f)
    with np.load(npz_path) as data:
        flat = {k: data[k] for k in data.files}
    trees = unflatten_npz({k: v.astype(np.float32) if v.dtype == np.float16
                           else v for k, v in flat.items()})
    cfg = Config(**meta['config']).derive('train')
    classifier = load_classifier(Classifier(cfg.num_classes),
                                 trees['params'], trees['aux'])
    native_hw = (cfg.output_height, cfg.output_width // 2)
    return _features(classifier, torch.device(device), native_hw)


def reconstruction_metrics(a: np.ndarray, b: np.ndarray) -> dict:
    """L1 / L2 / PSNR between two [-1, 1] image batches."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    return {
        'l1': float(np.mean(np.abs(a - b))),
        'mse': mse,
        'psnr_db': float('inf') if mse == 0
        else 20 * np.log10(2.0 / np.sqrt(mse)),
    }
