"""The range view's serving and train step: `RangeSegmenter` and
`RangeTrainer`, the `Segmenter` and `Trainer` that a config of a range
model (SalsaNext, FIDNet, CENet, RangeNet) gets from the engine's
constructors.  Counterpart of JAX `parallel/range_step.py`, wired as JAX
`engine.py:165-167, 350-373, 402-408` and evaluated on raw points as
`engine.py:835-882`.

A range model takes no topology.  `RangeSegmenter.predict` runs, per
batch of scans:

  1. host:    `RangeViewPipeline(training=False)` and its collate (the
              (B, H, W, 6) images, each point's pixel, range and image);
  2. forward: the model on the images, (B, H, W, C) f32 pixel logits;
  3. K9:      the KNN clean-up of the pixel argmax at every point of the
              batch, one launch (`range_point_labels`);
  4. mapping: each point's pixel logits, gathered at (proj_y, proj_x),
              and K9's labels.

`RangeTrainer` steps on the same images (`step(scans, others)`: the
mixes' second scans, none by default; the loader draws them), and its
`evaluate` counts pixels, its `evaluate_points` points labelled by K9.
"""

from __future__ import annotations

import torch

from .engine import Segmenter, Trainer, eval_mode
from .loss.range import range_class_weights, salsanext_loss
from .models.range2d.postproc import knn_postprocess
from .utils.metrics import confusion_hist

# the arrays of a collated range-view shard that the device reads
RANGE_KEYS = ("scan", "label", "mask", "px", "py", "unproj_range", "img")


def range_to_device(arrays: dict, device) -> dict:
    """Add the `<key>_t` device tensors of a collated range shard's
    `RANGE_KEYS`."""
    for k in RANGE_KEYS:
        arrays[k + "_t"] = torch.from_numpy(arrays[k]).to(device)
    return arrays


@torch.no_grad()
def range_point_labels(arrays: dict, logits: torch.Tensor, num_classes: int) -> torch.Tensor:
    """K9 over a range shard: each point's label (P,) int32, the KNN
    clean-up of the pixel argmax, over the range image as the model read
    it (image channel 4 x 80, so the rounding matches JAX's
    engine.py:857), one launch for every scan of the shard."""
    pix = logits.argmax(-1).to(torch.int32)
    proj_range = arrays["scan_t"][..., 4] * 80.0
    return knn_postprocess(
        proj_range.contiguous(), arrays["unproj_range_t"], pix, arrays["px_t"], arrays["py_t"],
        arrays["img_t"], num_classes=num_classes,
    )


def range_points(arrays: dict, logits: torch.Tensor, labels: torch.Tensor, offsets, samples,
                 padded=None):
    """Yields (sample, per-point pixel logits (N, C), K9's labels (N,))
    for every sample of a range shard that is not a padding repeat."""
    img, y, x = (arrays[k + "_t"].long() for k in ("img", "py", "px"))
    for b, s in enumerate(samples):
        if padded and padded[b]:
            continue
        sl = slice(int(offsets[b]), int(offsets[b + 1]))
        yield s, logits[img[sl], y[sl], x[sl]], labels[sl]


class RangeSegmenter(Segmenter):
    """`Segmenter` of a range model: per raw point its pixel's logits and
    K9's label, one K9 launch per batch of scans."""

    def __init__(self, cfg: dict, params: dict, device=None, **kwargs):
        super().__init__(cfg, params, device, **kwargs)
        self.num_class = int(cfg["MODEL"]["NUM_CLASS"])

    def collate(self, scans: list) -> dict:
        """Host stage: project the scans and collate their images."""
        return range_to_device(self.pipeline.collate([self.pipeline(s) for s in scans]), self.device)

    def forward(self, arrays: dict, topo=None) -> torch.Tensor:
        """(B, H, W, C) f32 pixel logits."""
        with torch.no_grad():
            return self.model(arrays["scan_t"])

    def point_labels(self, arrays: dict, logits: torch.Tensor) -> torch.Tensor:
        """Each point's label: K9 over the pixel argmax."""
        return range_point_labels(arrays, logits, self.num_class)

    def map_to_points(self, arrays: dict, logits: torch.Tensor, labels: torch.Tensor) -> list:
        return [
            {"logits": pt.cpu().numpy(), "labels": lab.cpu().numpy()}
            for _, pt, lab in range_points(arrays, logits, labels, arrays["offsets"], arrays["samples"])
        ]

    def predict(self, scans: list) -> list:
        results = []
        for i in range(0, len(scans), self.batch_size):
            arrays = self.collate(scans[i : i + self.batch_size])
            logits = self.forward(arrays)
            results.extend(self.map_to_points(arrays, logits, self.point_labels(arrays, logits)))
        return results


class RangeTrainer(Trainer):
    """`Trainer` of a range model (JAX `parallel/range_step.py:36-108`):
    the RangeViewPipeline's images, the model in train mode (flax-style
    BN statistics, dropout), `salsanext_loss` over the pixels valid =
    (mask > 0) & (label != 0) with the class weights of
    `range_class_weights` (DATA.DATASET, MODEL.LOSS_CONFIG.CLASS_WEIGHT)
    and MODEL.LOSS_CONFIG's TOP_K_PERCENT, LS_WEIGHT, BD_WEIGHT; CENet
    with its aux heads 1.25 x the main term plus the three aux terms (no
    top-k on those).  Its shard has no topology and no level counts.
    `evaluate` counts pixels (`range_step.py:111-124`), `evaluate_points`
    points, labelled by K9 (TTA votes do not apply, as in JAX)."""

    def __init__(self, cfg: dict, params: dict = None, device=None, **kwargs):
        super().__init__(cfg, params, device, **kwargs)
        self.kind = "range"

    def build_criterion(self, cfg: dict, loss_cfg: dict) -> None:
        w = range_class_weights(
            str(cfg.get("DATA", {}).get("DATASET", "semantickitti")), self.num_class,
            override=loss_cfg.get("CLASS_WEIGHT"),
        )
        self.class_weight = torch.from_numpy(w).to(self.device)
        self.loss_kw = dict(
            top_k_percent=float(loss_cfg.get("TOP_K_PERCENT", 1.0)),
            ls_weight=float(loss_cfg.get("LS_WEIGHT", 3.0)),
            bd_weight=float(loss_cfg.get("BD_WEIGHT", 1.0)),
        )

    def shard_to_device(self, arrays: dict) -> dict:
        return range_to_device(arrays, self.device)

    def collate(self, scans: list, others: list = None) -> dict:
        """Host stage: the scans' images, each with its mixes' second
        scan from `others`, on the device."""
        others = others or [None] * len(scans)
        return self.shard_to_device(
            self.pipeline.collate([self.pipeline(s, o) for s, o in zip(scans, others)])
        )

    def train_topology(self, arrays: dict):
        return None, []

    def forward(self, arrays: dict, topo=None) -> torch.Tensor:
        """The range step's loss (JAX `range_step.py:46-82`)."""
        label = arrays["label_t"]
        valid = (arrays["mask_t"] > 0) & (label != 0)
        out = self.model(arrays["scan_t"])
        kw = dict(self.loss_kw, class_weight=self.class_weight)
        if not isinstance(out, tuple):
            return salsanext_loss(out, label, valid, **kw)
        logits, aux = out
        loss = 1.25 * salsanext_loss(logits, label, valid, **kw)
        kw["top_k_percent"] = 1.0
        for al in aux:
            loss = loss + salsanext_loss(al, label, valid, **kw)
        return loss

    def step(self, scans: list, others: list = None) -> dict:
        """One train step on `batch_size` reader dicts, the mixes with
        `others` (one second scan each)."""
        return self.train_on(self.collate(scans, others))

    def _eval_batches(self, batches):
        """(arrays, meta, pixel logits) of each batch, in eval mode."""
        with eval_mode(self.model):
            for arrays, meta in batches:
                arrays = self.shard_to_device(arrays)
                with torch.no_grad():
                    logits = self.model(arrays["scan_t"])
                yield arrays, meta, logits

    def _eval_rows(self, arrays: dict, logits: torch.Tensor):
        labels = arrays["label_t"].reshape(-1)
        return logits.reshape(labels.shape[0], -1).argmax(-1), labels, arrays["mask_t"].reshape(-1) > 0

    def _point_hist(self, pred: torch.Tensor, sample) -> torch.Tensor:
        labels = torch.from_numpy(sample.point_labels).to(pred.device)
        return confusion_hist(pred, labels, labels != 0, self.num_class)

    def _point_predictions(self, tta_votes: int, save_score: bool):
        if tta_votes > 0:
            self.logger.info("TTA votes do not apply to the range view (as in JAX)")
        for arrays, meta, logits in self._eval_batches(self.val_loader):
            labels = range_point_labels(arrays, logits, self.num_class)
            for m in meta:
                for sample, _, pred in range_points(
                    arrays, logits, labels, m["offsets"], m["samples"], m.get("padded")
                ):
                    yield sample, pred, None
