"""Supervised Trainer: lifecycle orchestration around the train step
(counterpart of `efficientteacher_tpu/train/trainer.py`).

Parity with reference trainer/trainer.py:43-542:
  - set_env: run dir via increment_path, config dump (trainer.py:253)
  - build_model: model from cfg, warm-start via shape-matched partial load
    (intersect, trainer.py:132-144), EMA in the train state
  - build_optimizer: accumulate = 64/batch, scaled weight decay
    (trainer.py:195-197), SGD nesterov or AdamW (`adam`), one_cycle or
    linear LR; full resume (AdamW's two moments included)
  - autoanchor (`noautoanchor: False`, skipped on resume; JAX
    trainer.py:293-326): after the loaders, the labels' best possible
    recall against the anchors and, below 0.98, k-means + GA anchors
    (`data/autoanchor.py`), adopted by the spec, every anchor head's
    decode anchors (student and EMAs) and `anchors_grid` before the loss
    and the step are built
  - warmup iterations nw = clamp(round(warmup_epochs*nb), 1000, half-run)
    (trainer.py:372-376)
  - build_loss: the Loss.type dispatch, ComputeLoss (YOLOv5; with
    `Loss.assigner_type: SimOTA` the anchor OTA loss, YOLOv7's),
    ComputeXLoss / ComputeFastXLoss (YOLOX, SimOTA) and ComputeTalLoss (the
    TAL heads), with JAX's early ValueError on an anchor-free loss paired
    with an anchor head (JAX trainer.py:336-349)
  - before_epoch: close mosaic for the last no_aug_epochs (trainer.py:363-365)
    and, for YOLOX, turn on the L1 term there (trainer.py:366-368)
  - after_epoch: validate EMA, fitness = 0.1*mAP50+0.9*mAP, save last/best
    (trainer.py:445-491), asynchronously (utils/checkpoint.py)

The trainer runs on the CUDA card unless the caller passes `device="cpu"`;
it raises when a card is asked for and absent. The model trains in float32
master weights with the forward in `compute_dtype` (bf16 autocast by
default). Host syncs in the loop: the loss parts are read (`float`) only on
the batches the JAX trainer logs (every 50th).

The loaders read the dataset from disk (`data/`). Two augmentation
routes, as in JAX: by default (`Dataset.device_aug False`, every shipped
YAML) the host augments (`data/augment.py`: mosaic, perspective, HSV,
flips; `Dataset.quad` too), each batch drawing from its own seeded
generator; under `Dataset.device_aug True` the host decodes and
letterboxes, and mosaic, perspective, HSV and flips run on the card
(`ops/augment_device.py`), with draws seeded from the step counter.

RepOpt (`Model.RepOpt`): the scales of `Model.RepScale_weight` (a port
checkpoint of a LinearAdd model) re-initialise the RealVGG kernels of a
run from scratch and mask their gradients (`train/repopt.py`).

Warm starts (`weights`) read a port checkpoint or a reference `.pt`
(`utils/torch_import.py`), shape-matched.

DDP (`parallel/distributed.py`): each rank steps on its share of the
global batch, with the global batch's loss normalisers, BatchNorm
statistics and gradient (summed once per optimizer step), so the weights,
the EMA and the statistics stay the same on every rank; rank 0 alone
makes the run directory, writes `results.csv` and the checkpoints, and
validates the whole val set while the others wait for its results.

Loggers and plots, on rank 0 as in JAX: TensorBoard scalars at each
epoch end (`utils/loggers.py`, registered on the callbacks bus; skipped
without tensorboard), `labels.png` once the loaders are built, the first
three batches' mosaics `train_batch{0,1,2}.png` of the first epoch and
`results.png` at the end (`utils/plots.py`; skipped with a debug log
without matplotlib). The JAX trainer's `profile_steps` is not ported
(`torch.profiler` serves, ROADMAP Q1.12).
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..configs import CfgNode
from ..data.autoanchor import check_anchors
from ..data.datasets import (BatchLoader, LoadImagesAndLabels,
                             create_dataloader)
from ..eval import validator
from ..eval.metrics import MetricMeter, fitness
from ..losses.tal_loss import TALLossConfig, compute_tal_loss
from ..losses.yolov5_loss import YoloV5LossConfig, compute_loss
from ..losses.yolov5_ota_loss import compute_ota_loss
from ..losses.yolox_loss import YoloXLossConfig, compute_yolox_loss
from ..models import build_model, spec_from_cfg
from ..models.heads import head_model_type
from ..ops.augment_device import device_augment_batch, step_seed
from ..parallel.distributed import (broadcast_object, global_sum,
                                    group_active, is_main_process,
                                    per_process_batch, to_device,
                                    world_size)
from ..utils.callbacks import Callbacks
from ..utils.checkpoint import (AsyncCheckpointer, load_checkpoint,
                                load_module_variables, module_variables)
from ..utils.general import check_img_size, increment_path
from ..utils.loggers import Loggers
from ..utils.profile import count_params
from ..utils.shutdown import GracefulStop
from ..utils.torch_import import load_weights_into
from .optim import OptimizerConfig
from .repopt import (build_grad_masks, load_repscale_scales,
                     reinitialize_from_scales)
from .supervised import Schedule, make_supervised_train_step
from .train_state import create_train_state

LOGGER = logging.getLogger(__name__)

RESULTS_KEYS = [
    "epoch", "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall", "metrics/mAP_0.5",
    "metrics/mAP_0.5:0.95", "val/fitness", "lr",
]


class Trainer:
    # the SSOD trainer builds the SSOD detector (with its discriminators)
    ssod_model = False

    def __init__(self, cfg: CfgNode, callbacks: Optional[Callbacks] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA card is present; pass "
                               "device='cpu' to train on the CPU")
        self.cfg = cfg
        self.callbacks = callbacks or Callbacks()
        self.compute_dtype = compute_dtype
        self.epoch = 0
        self.start_epoch = 0
        self.best_fitness = 0.0
        self.set_env(cfg)
        # TensorBoard on the callbacks bus (reference trainer.py:281)
        self.loggers = None
        if self.is_main:
            self.loggers = Loggers(self.save_dir, cfg, include=("tb",))
            self.loggers.register(self.callbacks)
        self.build_model(cfg)
        self.build_optimizer(cfg)
        self.build_dataloader(cfg)
        self._plot("plot_labels", lambda: (self.dataset.labels, self.spec.nc,
                                           self.save_dir))
        self.autoanchor(cfg)
        self.build_loss(cfg)
        self.build_step()

    # -- lifecycle ----------------------------------------------------------
    def set_env(self, cfg):
        self.epochs = cfg.epochs
        self.batch_size = cfg.Dataset.batch_size
        self.is_main = is_main_process()
        self.rank = 0 if self.is_main else torch.distributed.get_rank()
        # rank 0 alone makes the run directory and writes into it
        save_dir = None
        if self.is_main:
            save_dir = increment_path(
                Path(cfg.project or "runs/train") / (cfg.name or "exp"),
                exist_ok=cfg.exist_ok, mkdir=True)
            (save_dir / "weights").mkdir(parents=True, exist_ok=True)
            (save_dir / "opt.yaml").write_text(cfg.dump())
        self.save_dir = Path(broadcast_object(save_dir and str(save_dir)))
        self.img_size = check_img_size(cfg.Dataset.img_size, 32)
        self.noval = cfg.noval
        self.nosave = cfg.nosave
        self.save_period = cfg.save_period
        self.results_csv = self.save_dir / "results.csv"
        self.checkpointer = AsyncCheckpointer()
        self.stop = GracefulStop()
        # device_aug: the loaders serve letterboxed images and the batch is
        # augmented on the card with draws seeded from the step counter
        self.device_aug = bool(cfg.Dataset.device_aug)
        self.aug_hyp = {k: cfg.hyp[k] for k in cfg.hyp}
        self.aug_gen = torch.Generator(device=self.device)

    def _plot(self, fn: str, args) -> None:
        """utils/plots.`fn`(*args()) on rank 0; without matplotlib, or on a
        plot that fails, a debug log (plots are never fatal, as in JAX)."""
        if not self.is_main:
            return
        from ..utils import plots

        try:
            getattr(plots, fn)(*args())
        except Exception as e:  # noqa: BLE001 - never fatal
            LOGGER.debug("%s skipped: %s", fn, e)

    def build_model(self, cfg):
        self.spec = dataclasses.replace(spec_from_cfg(cfg),
                                        train_domain=self.ssod_model)
        model = build_model(self.spec, device=self.device,
                            generator=torch.Generator().manual_seed(0))
        if self.device.type == "cuda":
            # NHWC images arrive as channels-last views (train/supervised.py)
            model = model.to(memory_format=torch.channels_last)
        LOGGER.info("Model summary: %s/%s/%s head, %.2fM parameters",
                    self.spec.backbone, self.spec.neck, self.spec.head,
                    count_params(model) / 1e6)
        if cfg.weights:
            self._warm_start(cfg.weights, model)
        # RepOptimizer (reference trainer/trainer.py:219-236; JAX
        # trainer.py:140-162): the LinearAdd checkpoint's scales make
        # per-kernel gradient masks; a run from scratch also re-initialises
        # the 3x3 kernels to the fused CSLA equivalent
        self.grad_masks = None
        if cfg.Model.RepOpt:
            scales = load_repscale_scales(cfg.Model.RepScale_weight)
            if not cfg.weights:
                reinitialize_from_scales(model, scales)
            self.grad_masks = build_grad_masks(model, scales)
        self.model = model
        s = np.asarray(self.spec.strides, np.float32)[:, None, None]
        self.anchors_grid = torch.from_numpy(
            np.asarray(self.spec.anchors, np.float32)
            .reshape(self.spec.nl, -1, 2) / s).to(self.device)

    def _warm_start(self, weights: str, model: torch.nn.Module):
        """Shape-matched partial load, in place, from a port checkpoint
        (its `ema` entry if it has one) or a reference `.pt`
        (`utils/torch_import.py`)."""
        c = load_weights_into(model, weights)
        LOGGER.info("warm start: %d/%d params, %d/%d stats from %s",
                    *c["params"], *c["batch_stats"], weights)
        self.warm_start_counts = c

    def build_optimizer(self, cfg):
        nbs = 64
        self.accumulate = max(round(nbs / self.batch_size), 1)
        scaled_wd = (
            cfg.hyp.weight_decay * self.batch_size * self.accumulate / nbs
        )
        self.opt_cfg = OptimizerConfig.from_cfg(cfg, scaled_wd)
        self.state = create_train_state(self.model, self.opt_cfg,
                                        with_ema=True)
        if cfg.resume and cfg.weights and not cfg.weights.endswith(".pt"):
            self._resume(cfg.weights)

    def _resume(self, weights):
        """Full resume: params + BN stats + EMA + optimizer momentum + epoch
        (reference trainer.py:159-186)."""
        self._restore(load_checkpoint(weights))
        LOGGER.info("resumed at epoch %d (best_fitness %.4f)",
                    self.start_epoch, self.best_fitness)

    def _restore(self, ckpt):
        meta = ckpt.get("meta", {})
        self.start_epoch = self.epoch = meta.get("epoch", -1) + 1
        self.best_fitness = meta.get("best_fitness", 0.0)
        st = self.state
        load_module_variables(st.model, ckpt["model"])
        if st.ema is not None and "ema" in ckpt:
            load_module_variables(st.ema.module, ckpt["ema"])
            st.ema.updates = int(meta.get("ema_updates", 0))
        opt = ckpt.get("optimizer")
        if opt is not None:
            with torch.no_grad():
                for (name, _), buf in zip(st.model.named_parameters(),
                                          st.momentum_buf):
                    buf.copy_(opt["momentum_buf"][name])
                if st.second_moment is not None:
                    for (name, _), v in zip(st.model.named_parameters(),
                                            st.second_moment):
                        v.copy_(opt["second_moment"][name])
            st.opt_step = int(opt["step"])

    def _optimizer_state(self):
        """The momentum (AdamW: both moments) and the fired-step count, by
        parameter name: the `optimizer` entry of `last.ckpt` (the resume
        source; the reference keeps it in last.pt and strips it from
        best)."""
        st = self.state
        names = [n for n, _ in st.model.named_parameters()]
        out = {"momentum_buf": dict(zip(names, st.momentum_buf)),
               "step": st.opt_step}
        if st.second_moment is not None:
            out["second_moment"] = dict(zip(names, st.second_moment))
        return out

    def build_dataloader(self, cfg):
        """Set the loaders (JAX trainer.py build_dataloader):

          train_loader  under device_aug a plain (letterboxing) loader over
                        Dataset.train, shuffled, dropping the last partial
                        batch; otherwise `create_dataloader(cfg, "train")`,
                        which augments on the host under hyp.use_aug
          val_loader    `create_dataloader(cfg, "val", augment=False)`, or
                        None without Dataset.val
          dataset, nb   train_loader.ds, len(train_loader)

        On the card the loaders write their images into pinned memory.
        Callers who bring their own batches override this method and set
        the same attributes, to the `BatchLoader` contract: batch dicts
        with "images" uint8 (B, H, W, 3) (array or CPU tensor), "labels"
        float32 (B, M, 5) [cls, cx, cy, w, h] normalised, "mask" bool
        (B, M); val batches also "shapes" (B,) native (h, w) or None and
        optionally "ratio_pad" (B,) ((rh, rw), (dw, dh)); the SSOD
        target_loader "images" (the strong view), "images_ori" (the weak
        view) and "M_s" float32 (B, 13), or under device_aug "images_ori",
        "labels" and "mask"; `dataset` has `labels`, `mosaic`,
        `label_num_per_image`, `cls_ratio_gt`."""
        pin = self.device.type == "cuda"
        if self.device_aug:
            ds = LoadImagesAndLabels(
                cfg.Dataset.train,
                img_size=cfg.Dataset.img_size,
                nc=cfg.Dataset.nc,
                max_targets=cfg.Dataset.max_targets,
                single_cls=cfg.single_cls,
                cache_images=cfg.cache is True or cfg.cache == "ram",
                num_keypoints=int(cfg.Dataset.np),
                native_loader=bool(cfg.Dataset.native_loader),
            )
            self.train_loader = BatchLoader(
                ds, per_process_batch(self.batch_size), shuffle=True,
                drop_last=True, sampler_type=cfg.Dataset.sampler_type,
                workers=int(cfg.Dataset.workers),
                mode=str(cfg.Dataset.loader), pin_memory=pin)
        else:
            self.train_loader = create_dataloader(
                cfg, "train", batch_size=self.batch_size, pin_memory=pin)
        self.dataset = self.train_loader.ds
        self.nb = len(self.train_loader)
        self.val_loader = (
            create_dataloader(cfg, "val", augment=False,
                              batch_size=self.batch_size, pin_memory=pin)
            if cfg.Dataset.val else None)

    def autoanchor(self, cfg):
        """The train-start anchor check behind `noautoanchor`, skipped on
        resume and for anchor-free heads (JAX trainer.py:293-326;
        reference utils/autoanchor.py:26-49): the best possible recall of
        the dataset's labels against the anchors and, below 0.98, evolved
        anchors, which are adopted when their recall is higher. Adopted
        anchors go into the spec, the decode anchors of every head of the
        student and its EMAs, and `anchors_grid`. Sets `self.anchor_check`
        = {"bpr", "adopted"} when the check runs."""
        if cfg.noautoanchor or cfg.resume \
                or head_model_type(self.spec.head) != "yolov5":
            return
        nl = self.spec.nl
        anchors_px = np.asarray(self.spec.anchors,
                                np.float32).reshape(nl, -1, 2)
        new_px, bpr = check_anchors(self.dataset, anchors_px,
                                    self.spec.strides, self.img_size,
                                    anchor_t=float(cfg.Loss.anchor_t))
        adopted = not np.allclose(new_px, anchors_px)
        self.anchor_check = {"bpr": bpr, "adopted": adopted}
        if not adopted:
            return
        LOGGER.info("autoanchor: adopting evolved anchors (BPR %.4f)", bpr)
        new_px = np.asarray(new_px, np.float32)
        self.spec = dataclasses.replace(
            self.spec, anchors=tuple(tuple(float(v) for v in sc.reshape(-1))
                                     for sc in new_px))
        st = self.state
        modules = [st.model] + [e.module for e in (
            st.ema, getattr(st, "semi_ema", None)) if e is not None]
        with torch.no_grad():
            for module in modules:
                for m in module.modules():
                    if isinstance(getattr(m, "anchors_px", None),
                                  torch.Tensor):
                        m.anchors_px.copy_(torch.from_numpy(new_px))
        s = np.asarray(self.spec.strides, np.float32)[:, None, None]
        self.anchors_grid = torch.from_numpy(new_px / s).to(self.device)

    def augment(self, images, labels, mask, stream: int, ni: int,
                part: int = 0):
        """The labelled batch augmented on the card (under device_aug),
        drawn from step_seed(stream, ni, part); else as it is."""
        if not self.device_aug:
            return images, labels, mask
        self.aug_gen.manual_seed(step_seed(stream, ni, part, self.rank))
        return device_augment_batch(
            self.aug_gen, images, labels.float(), mask, self.aug_hyp,
            max_out=int(self.cfg.Dataset.max_targets))

    def build_loss(self, cfg):
        """Loss.type dispatch (JAX trainer.py:330-394): ComputeLoss for
        anchor heads (its OTA form with assigner_type SimOTA),
        ComputeXLoss / ComputeFastXLoss (YOLOX) and ComputeTalLoss (the TAL
        heads), each set as the step's `detection_loss`."""
        loss_type = cfg.Loss.type
        # fail early on a head/loss family mismatch: the default Loss.type
        # is ComputeXLoss, which only fits anchor-free heads; with an
        # anchor head it would surface as a shape error inside the loss
        if loss_type in ("ComputeXLoss", "ComputeFastXLoss",
                         "ComputeTalLoss") \
                and head_model_type(self.spec.head) == "yolov5":
            raise ValueError(
                f"Loss.type {loss_type!r} is anchor-free but head "
                f"{self.spec.head!r} is anchor-based — set Loss.type: "
                "'ComputeLoss' (every shipped anchor-head YAML does)")
        self.loss_cfg = YoloV5LossConfig.from_cfg(cfg, nl=self.spec.nl)
        if loss_type == "ComputeLoss":
            anchors, lc = self.anchors_grid, self.loss_cfg
            if cfg.Loss.assigner_type == "SimOTA":
                # the anchor OTA loss (reference ComputeLoss.ota_loss,
                # loss.py:215-303; JAX trainer.py:354-365)
                strides, img = self.spec.strides, self.img_size
                top_k = int(cfg.Loss.top_k)  # reference loss.py:131-137

                def det_loss(raw, labels, mask):
                    return compute_ota_loss(raw, labels, mask, anchors,
                                            strides, img, lc, top_k=top_k)
            else:
                def det_loss(raw, labels, mask):
                    return compute_loss(raw, labels, mask, anchors, lc)

        elif loss_type in ("ComputeXLoss", "ComputeFastXLoss"):
            det_loss = self._yolox_loss(use_l1=False)
        elif loss_type == "ComputeTalLoss":
            self.tal_cfg = TALLossConfig.from_cfg(cfg)
            img, tc = self.img_size, self.tal_cfg

            def det_loss(raw, labels, mask):
                return compute_tal_loss(raw, labels, mask, img, tc)

        else:
            raise NotImplementedError(f"Loss.type {loss_type!r}")
        self.detection_loss = det_loss

    def _yolox_loss(self, use_l1: bool):
        """The YOLOX loss at the config's settings, with or without L1."""
        self.yolox_cfg = YoloXLossConfig.from_cfg(self.cfg, use_l1=use_l1)
        img, xc = self.img_size, self.yolox_cfg

        def det_loss(raw, labels, mask):
            return compute_yolox_loss(raw, labels, mask, img, xc)

        return det_loss

    def build_step(self):
        self.train_step = make_supervised_train_step(
            opt_cfg=self.opt_cfg,
            norm_scale=float(self.cfg.Dataset.norm_scale),
            compute_dtype=self.compute_dtype,
            detection_loss=self.detection_loss,
            grad_masks=self.grad_masks,
        )

    def _to_device(self, *arrays):
        out = tuple(to_device(a, self.device) for a in arrays)
        return out if len(out) > 1 else out[0]

    # -- schedule -----------------------------------------------------------
    def _warmup_iters(self) -> int:
        if self.cfg.hyp.warmup_epochs > 0:
            nw = max(round(self.cfg.hyp.warmup_epochs * self.nb), 1000)
            return int(min(nw, (self.epochs - self.start_epoch) / 2 * self.nb))
        return -1

    def _schedule(self, ni: int) -> Schedule:
        s = self.opt_cfg.schedule(ni, self.epoch, self._warmup_iters())
        if self._warmup_iters() > 0 and ni <= self._warmup_iters():
            accumulate = max(
                1, round(np.interp(ni, [0, self._warmup_iters()],
                                   [1, 64 / self.batch_size]))
            )
        else:
            accumulate = self.accumulate
        return Schedule.make(
            s["lr_bias"], s["lr_rest"], s["momentum"], accumulate,
            ema_decay=0.9999,
        )

    # -- loop ---------------------------------------------------------------
    def before_epoch(self):
        if self.epoch == self.epochs - self.cfg.hyp.no_aug_epochs:
            LOGGER.info("closing mosaic augmentation")
            self.dataset.mosaic = False
            self.aug_hyp["mosaic"] = 0.0
            if self.cfg.Loss.type in ("ComputeXLoss", "ComputeFastXLoss"):
                # YOLOX: the extra L1 term for the no-aug tail (reference
                # trainer.py:366-368)
                self.detection_loss = self._yolox_loss(use_l1=True)
                self.build_step()
        self.meter = MetricMeter()

    def train_in_epoch(self):
        for i, batch in enumerate(self.train_loader):
            ni = i + self.nb * self.epoch
            if self.epoch == self.start_epoch and i < 3:
                # the first batches' mosaics (reference loggers plot_images
                # on the first 3 train batches, utils/loggers/__init__.py:88)
                self._plot("plot_images", lambda: (
                    np.asarray(batch["images"]), np.asarray(batch["labels"]),
                    np.asarray(batch["mask"]),
                    self.save_dir / f"train_batch{i}.png"))
            sched = self._schedule(ni)
            images, labels, mask = self.augment(*self._to_device(
                batch["images"], batch["labels"], batch["mask"]), 0, ni)
            self.state, parts = self.train_step(
                self.state, images, labels, mask, sched
            )
            if i % 50 == 0:
                self.meter.update(self._logged(parts))
                LOGGER.info("epoch %d it %d/%d %s", self.epoch, i, self.nb,
                            self.meter)
            self.callbacks.run("on_train_batch_end")
            if self._stop_requested():
                break

    def _stop_requested(self) -> bool:
        """A graceful stop asked for (SIGTERM / Ctrl-C); under DDP with more
        than one rank, asked for on any rank, so that all stop at the same
        step (one all-reduce per step)."""
        if world_size() == 1:
            return self.stop.requested
        flag = torch.tensor([float(self.stop.requested)], device=self.device)
        self.stop.requested = bool(global_sum(flag).item() > 0)
        return self.stop.requested

    def _validate(self, ema):
        """validator.run over the whole val loader with `ema` (an
        EMAState) on rank 0, its results on every rank (the others wait
        for them, as the reference's ranks wait for rank 0's val)."""
        results = None
        if self.is_main:
            results, _, _ = validator.run(
                ema.module, self.val_loader, nc=self.spec.nc,
                conf_thres=float(self.cfg.val_conf_thres),
                norm_scale=float(self.cfg.Dataset.norm_scale),
                compute_dtype=self.compute_dtype,
            )
        return broadcast_object(results)

    @staticmethod
    def _logged(parts: dict) -> dict:
        """A step's loss parts as floats, summed over the ranks under DDP
        (each rank's are its share of the global batch's)."""
        keys = [k for k in parts if k not in ("loss", "total")]
        if not keys or not group_active():
            return {k: float(parts[k]) for k in keys}
        vals = torch.stack([torch.as_tensor(parts[k]).detach().double()
                            .reshape(()) for k in keys])
        return dict(zip(keys, global_sum(vals).tolist()))

    def after_epoch(self):
        results = (0.0, 0.0, 0.0, 0.0)
        if self.val_loader is not None and not self.noval:
            results = self._validate(self.state.ema)
            LOGGER.info(
                "epoch %d val P=%.4f R=%.4f mAP50=%.4f mAP=%.4f",
                self.epoch, *results,
            )
        fi = float(fitness(np.array([list(results)]))[0])
        if fi > self.best_fitness:
            self.best_fitness = fi
        if self.is_main:
            self._write_results_row(results, fi)
        if not self.nosave and self.is_main:
            self._save_ckpt("last.ckpt", fi)
            if fi == self.best_fitness:
                self._save_ckpt("best.ckpt", fi)
            if self.save_period > 0 and self.epoch % self.save_period == 0:
                self._save_ckpt(f"epoch{self.epoch}.ckpt", fi)
        metrics = {
            "metrics/precision": results[0],
            "metrics/recall": results[1],
            "metrics/mAP_0.5": results[2],
            "metrics/mAP_0.5:0.95": results[3],
            "x/lr0": self.opt_cfg.lr0 * self.opt_cfg.lf(self.epoch),
        }
        for k, meter in self.meter.meters.items():
            metrics[f"train/{k}_loss"] = meter.avg
        self.callbacks.run("on_fit_epoch_end", metrics, self.epoch)

    def _write_results_row(self, results, fi):
        new = not self.results_csv.exists()
        with open(self.results_csv, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(RESULTS_KEYS)
            m = self.meter.meters
            w.writerow([
                self.epoch,
                m.get("box", None) and m["box"].avg or 0.0,
                m.get("obj", None) and m["obj"].avg or 0.0,
                m.get("cls", None) and m["cls"].avg or 0.0,
                *results, fi,
                self.opt_cfg.lr0 * self.opt_cfg.lf(self.epoch),
            ])

    def _save_ckpt(self, name: str, fi: float, epoch: Optional[int] = None):
        # async: on-device snapshot now, the copy to the host and the write
        # on the ckpt-writer thread (utils/checkpoint.py AsyncCheckpointer)
        st = self.state
        student = module_variables(st.model)
        ema = module_variables(st.ema.module) if st.ema else None
        opt = self._optimizer_state() if name == "last.ckpt" else None
        self.checkpointer.save(
            self.save_dir / "weights" / name,
            params=student["params"],
            batch_stats=student["batch_stats"],
            ema_params=ema["params"] if ema else None,
            ema_batch_stats=ema["batch_stats"] if ema else None,
            ema_updates=st.ema.updates if st.ema else 0,
            opt_state=opt,
            epoch=self.epoch if epoch is None else epoch,
            best_fitness=self.best_fitness,
            cfg_yaml=self.cfg.dump(),
        )
        self.callbacks.run("on_model_save",
                           self.save_dir / "weights" / name,
                           self.epoch if epoch is None else epoch, fi, name)

    def train(self):
        self.callbacks.run("on_train_start")
        # preemption (SIGTERM) / Ctrl-C: finish step, save, exit cleanly
        self.stop.install()
        t0 = time.time()
        try:
            for self.epoch in range(self.start_epoch, self.epochs):
                self.callbacks.run("on_train_epoch_start")
                self.before_epoch()
                self.train_in_epoch()
                if self.stop.requested:
                    LOGGER.warning(
                        "graceful stop at epoch %d: saving last.ckpt "
                        "(resume restarts this epoch), skipping val",
                        self.epoch)
                    if not self.nosave and self.is_main:
                        # epoch-1: the interrupted epoch is incomplete;
                        # resume (meta.epoch + 1) must re-run it
                        self._save_ckpt("last.ckpt", self.best_fitness,
                                        epoch=self.epoch - 1)
                    break
                self.after_epoch()
        finally:
            # even on an epoch-loop exception: restore default signal
            # handlers and join the async checkpoint writer so a mid-write
            # daemon isn't killed at interpreter exit and a failed save's
            # exception surfaces
            self.stop.uninstall()
            self.checkpointer.wait()  # last/best.ckpt durable before return
        LOGGER.info(
            "%d epochs in %.1f h, best fitness %.4f",
            self.epochs - self.start_epoch, (time.time() - t0) / 3600,
            self.best_fitness,
        )
        if self.results_csv.exists():   # training curves (plot_results)
            self._plot("plot_results", lambda: (self.results_csv,))
        self.callbacks.run("on_train_end")
        return self.best_fitness
