"""SSOD Trainer: mean-teacher lifecycle around the SSOD step (counterpart of
`efficientteacher_tpu/train/ssod_trainer.py`).

Parity with reference trainer/ssod_trainer.py:53-714:
  - env: burn_epochs, epoch_adaptor, cosine_ema, teacher_loss_weight
    (:76-84)
  - model: SSOD detector + semi_ema teacher chain (:96-203)
  - dataloaders: labeled + target loaders (:205-255); by default the
    target loader makes the weak / strong pairs and M_s on the host
    (`data/datasets_ssod.py`, AutoAugment included); under
    `Dataset.device_aug` it serves letterboxed weak views and the strong
    view, its labels and M_s are made on the card (`device_ssod_views`),
    the labelled batch augmented as in the supervised trainer; one step
    seed gives both draws (the JAX keys' `split` of
    `fold_in(PRNGKey(2), ni)`)
  - epoch dispatch (:295-317): epoch < burn_epochs -> supervised burn-in
    (optionally with DA losses); at burn_epochs the EMA is copied into the
    student and the teacher is seeded (:305-316); afterwards mean-teacher
  - epoch_adaptor (:685-697): the UNLABELED loader drives the epoch; labeled
    batches come from an endless iterator
  - after_epoch (:319-419): cosine EMA decay, validation of the (semi-)EMA
    teacher, teacher saved as the ckpt `ema`
  - pseudo-label quality meters (:655-680), on the logged batches only

Differences from the JAX trainer:
  - pseudo labels are copied to the host only on the batches it logs
    (every 50th), not on every step: the FairPseudoLabel path needs them
    nowhere else, and each copy waits for the card;
  - the endless labelled iterator iterates its loader again on each pass
    (`_cycle`); `itertools.cycle` keeps every batch of the first pass;
  - `resume` restores the state (the JAX SSOD trainer's build_optimizer
    never calls `_resume`), so `last.ckpt` holds the optimizer momentum
    and, past seeding, the student's EMA (the pseudo-label teacher) with
    its count as `student_ema`, beside the teacher (semi-EMA) as `ema`.
Not ported yet (NotImplementedError): LabelMatch (`pseudo_label_type:
LabelMatch`, ROADMAP Q1.6), extra teachers, the SSOD OTA loss and the
SSOD losses of the anchor-free heads (Q1.10); the pseudo-label debug
plots are skipped (Q1.8).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..data.datasets_ssod import create_target_dataloader
from ..eval.metrics import fitness
from ..losses.ssod_loss import SSODLossConfig
from ..models.heads import head_model_type
from ..ops.augment_device import device_ssod_views, step_seed
from ..parallel.distributed import to_host
from ..ssod.quality import check_pseudo_label, check_pseudo_label_with_gt
from ..utils.checkpoint import load_module_variables, module_variables
from .optim import OptimizerConfig
from .ssod_step import (create_ssod_train_state, make_burn_in_train_step,
                        make_ssod_train_step, seed_teacher_from_ema)
from .train_state import cosine_ema_decay
from .trainer import Trainer

LOGGER = logging.getLogger(__name__)


def _cycle(loader):
    """Batches of `loader` without end, iterating it again on each pass."""
    while True:
        yield from loader


class SSODTrainer(Trainer):
    ssod_model = True

    def set_env(self, cfg):
        if str(cfg.SSOD.pseudo_label_type) == "LabelMatch":
            raise NotImplementedError(
                "LabelMatch is not ported yet (ROADMAP Q1.6); "
                "use pseudo_label_type: FairPseudoLabel")
        if cfg.SSOD.extra_teachers or cfg.SSOD.use_ota:
            raise NotImplementedError(
                "extra teachers and the SSOD OTA loss are not ported yet "
                "(ROADMAP Q1.10)")
        super().set_env(cfg)
        if (cfg.Dataset.device_aug
                and float(cfg.SSOD.ssod_hyp.autoaugment) > 0
                and (cfg.SSOD.ssod_hyp.with_gt or cfg.SSOD.debug)):
            # as in JAX, the card's strong view has no AutoAugment; the
            # host route applies it only where the target keeps its labels
            LOGGER.warning(
                "SSOD.ssod_hyp.autoaugment %s is not applied under "
                "Dataset.device_aug: the strong view on the card has no "
                "AutoAugment, which the host route (device_aug False) "
                "applies to targets with labels (ROADMAP F2)",
                cfg.SSOD.ssod_hyp.autoaugment)
        self.burn_epochs = int(cfg.hyp.burn_epochs)
        self.epoch_adaptor = bool(cfg.SSOD.epoch_adaptor)
        self.cosine_ema = bool(cfg.SSOD.cosine_ema)
        self.ema_rate = float(cfg.SSOD.ema_rate)
        self.teacher_loss_weight = float(cfg.SSOD.teacher_loss_weight)
        self.with_da_loss = bool(cfg.SSOD.with_da_loss)
        self.da_loss_weights = float(cfg.SSOD.da_loss_weights)
        self.target_with_gt = bool(cfg.SSOD.ssod_hyp.with_gt or cfg.SSOD.debug)
        self.ssod_hyp = {k: cfg.SSOD.ssod_hyp[k] for k in cfg.SSOD.ssod_hyp}
        self.teacher_seeded = False
        # monotonic batch counter shared by the burn-in and mean-teacher
        # phases so the warmup/accumulate interpolation never jumps when the
        # target-loader length differs from self.nb (reference counts ni
        # over a single nb-based axis)
        self.global_step = None

    def _next_ni(self) -> int:
        if self.global_step is None:
            self.global_step = self.nb * self.start_epoch
        else:
            self.global_step += 1
        return self.global_step

    def build_optimizer(self, cfg):
        nbs = 64
        self.accumulate = max(round(nbs / self.batch_size), 1)
        if cfg.SSOD.fixed_accumulate:
            self.accumulate = 1
        scaled_wd = (
            cfg.hyp.weight_decay * self.batch_size * self.accumulate / nbs
        )
        self.opt_cfg = OptimizerConfig.from_cfg(cfg, scaled_wd)
        self.state = create_ssod_train_state(self.model, self.opt_cfg)
        if cfg.resume and cfg.weights and not cfg.weights.endswith(".pt"):
            self._resume(cfg.weights)

    def build_dataloader(self, cfg):
        super().build_dataloader(cfg)
        # augment=False serves raw letterboxed weak views (device_aug), else
        # the host makes the weak / strong pairs
        self.target_loader = create_target_dataloader(
            cfg, batch_size=self.batch_size, augment=not self.device_aug,
            pin_memory=self.device.type == "cuda")

    def _restore(self, ckpt):
        """The base restore (student, EMA, momentum, epoch), then the
        teacher chain of a checkpoint saved past seeding: its `ema` is the
        semi-EMA and `student_ema` the EMA, each with its count."""
        super()._restore(ckpt)
        if "student_ema" not in ckpt:
            return  # saved before seeding: `ema` is the EMA
        st, ent = self.state, ckpt["student_ema"]
        load_module_variables(st.semi_ema.module, ckpt["ema"])
        st.semi_ema.updates = st.ema.updates
        load_module_variables(st.ema.module, ent)
        st.ema.updates = int(ent["updates"])
        # a graceful stop in the seeding epoch re-runs it, seeding again
        self.teacher_seeded = self.start_epoch > self.burn_epochs

    def build_loss(self, cfg):
        super().build_loss(cfg)
        if head_model_type(self.spec.head) != "yolov5":
            raise NotImplementedError(
                f"the SSOD losses of the {self.spec.head!r} head are not "
                "ported yet (ROADMAP Q1.10); the port's SSOD trainer runs "
                "anchor heads")
        self.ssod_loss_cfg = SSODLossConfig.from_cfg(cfg, nl=self.spec.nl)
        # FairPseudoLabel's fixed per-class thresholds (LabelMatch would
        # refresh them per epoch)
        nc = self.spec.nc
        s = cfg.SSOD
        self.cls_thr_high = torch.full((nc,), float(s.ignore_thres_high),
                                       device=self.device)
        self.cls_thr_low = torch.full((nc,), float(s.ignore_thres_low),
                                      device=self.device)

    def build_step(self):
        cfg = self.cfg
        self.burn_step = make_burn_in_train_step(
            self.loss_cfg, self.anchors_grid, self.opt_cfg,
            with_da_loss=self.with_da_loss,
            da_loss_weight=self.da_loss_weights,
            norm_scale=float(cfg.Dataset.norm_scale),
            compute_dtype=self.compute_dtype,
        )
        self.ssod_step = make_ssod_train_step(
            self.loss_cfg, self.ssod_loss_cfg, self.anchors_grid,
            self.opt_cfg, self.spec,
            nms_conf_thres=float(cfg.SSOD.nms_conf_thres),
            nms_iou_thres=float(cfg.SSOD.nms_iou_thres),
            max_pl=int(cfg.SSOD.max_pseudo_labels),
            multi_label=bool(cfg.SSOD.multi_label),
            teacher_loss_weight=self.teacher_loss_weight,
            da_loss_weight=self.da_loss_weights,
            with_da_loss=self.with_da_loss,
            norm_scale=float(cfg.Dataset.norm_scale),
            compute_dtype=self.compute_dtype,
        )

    # -- epoch logic --------------------------------------------------------
    def _semi_decay(self) -> float:
        if self.cosine_ema:
            return cosine_ema_decay(
                max(self.epoch - self.burn_epochs, 0),
                max(self.epochs - self.burn_epochs, 1),
                decay_start=self.ema_rate,
            )
        return self.ema_rate

    def train_in_epoch(self):
        if self.epoch == self.burn_epochs and not self.teacher_seeded:
            LOGGER.info("burn-in complete: seeding teacher from EMA")
            self.state = seed_teacher_from_ema(self.state)
            self.teacher_seeded = True
        if self.epoch < self.burn_epochs:
            self._train_burn_in()
        else:
            self._train_with_unlabeled()

    def _train_burn_in(self):
        target_iter = _cycle(self.target_loader) if self.with_da_loss \
            else None
        for i, batch in enumerate(self.train_loader):
            ni = self._next_ni()
            sched = self._schedule(ni)
            t_imgs = (self._to_device(next(target_iter)["images_ori"])
                      if target_iter else None)
            images, labels, mask = self.augment(*self._to_device(
                batch["images"], batch["labels"], batch["mask"]), 1, ni)
            self.state, parts = self.burn_step(
                self.state, images, labels, mask, t_imgs, sched,
                self._semi_decay(),
            )
            if i % 50 == 0:
                self.meter.update({k: float(v) for k, v in parts.items()
                                   if k != "loss"})
                LOGGER.info("burn epoch %d it %d/%d %s", self.epoch, i,
                            self.nb, self.meter)
            if self.stop.requested:
                break

    def _train_with_unlabeled(self):
        semi_decay = self._semi_decay()
        # the unlabeled loader drives; labeled batches from an endless iter
        unlabeled = self.target_loader
        labeled_iter = _cycle(self.train_loader)
        n_iter = len(unlabeled) if self.epoch_adaptor \
            else min(len(unlabeled), self.nb)
        for i, tbatch in enumerate(unlabeled):
            if i >= n_iter:
                break
            sbatch = next(labeled_iter)
            ni = self._next_ni()
            sched = self._schedule(ni)
            s_imgs, s_labels, s_mask = self.augment(*self._to_device(
                sbatch["images"], sbatch["labels"], sbatch["mask"]), 2, ni)
            if self.device_aug:
                # only the weak view crosses to the card; the strong view,
                # its labels and M_s are made there
                t_weak, t_labels, t_mask = self._to_device(
                    tbatch["images_ori"], tbatch["labels"], tbatch["mask"])
                self.aug_gen.manual_seed(step_seed(2, ni, 1))
                t_strong, t_labels, t_mask, t_weak, t_ms = device_ssod_views(
                    self.aug_gen, t_weak, t_labels.float(), t_mask,
                    self.ssod_hyp, max_out=int(self.cfg.Dataset.max_targets))
            else:
                t_strong, t_weak, t_ms = self._to_device(
                    tbatch["images"], tbatch["images_ori"], tbatch["M_s"])
                t_labels, t_mask = tbatch.get("labels"), tbatch.get("mask")
            self.state, out = self.ssod_step(
                self.state, s_imgs, s_labels, s_mask,
                t_strong, t_weak, t_ms,
                self.cls_thr_high, self.cls_thr_low, sched, semi_decay,
            )
            if i % 50 == 0:
                metrics = {k: float(v) for k, v in out.metrics.items()
                           if k not in ("loss", "total")}
                pl_np = to_host(out.pseudo_labels)
                mask_np = to_host(out.pseudo_mask)
                if self.target_with_gt:
                    # the strong view's labels (made on the card under
                    # device_aug)
                    metrics.update(check_pseudo_label_with_gt(
                        pl_np, mask_np, to_host(t_labels), to_host(t_mask),
                    ))
                else:
                    metrics.update(check_pseudo_label(pl_np, mask_np))
                self.meter.update(metrics)
                LOGGER.info("ssod epoch %d it %d/%d %s", self.epoch, i,
                            n_iter, self.meter)
            if self.stop.requested:
                break

    def after_epoch(self):
        # validate the teacher (semi_ema after burn-in, else EMA)
        results = (0.0, 0.0, 0.0, 0.0)
        if self.val_loader is not None and not self.noval:
            results = self._validate(
                self.state.semi_ema if self.teacher_seeded
                else self.state.ema)
            LOGGER.info("epoch %d teacher val P=%.4f R=%.4f mAP50=%.4f "
                        "mAP=%.4f", self.epoch, *results)
        fi = float(fitness(np.array([list(results)]))[0])
        if fi > self.best_fitness:
            self.best_fitness = fi
        if self.is_main:
            self._write_results_row(results, fi)
        metrics = {
            "metrics/precision": results[0],
            "metrics/recall": results[1],
            "metrics/mAP_0.5": results[2],
            "metrics/mAP_0.5:0.95": results[3],
        }
        for k, meter in self.meter.meters.items():
            metrics[f"train/{k}"] = meter.avg
        self.callbacks.run("on_fit_epoch_end", metrics, self.epoch)
        if not self.nosave and self.is_main:
            self._save_ckpt("last.ckpt", fi)
            if fi == self.best_fitness:
                self._save_ckpt("best.ckpt", fi)

    def _save_ckpt(self, name: str, fi: float, epoch=None):
        """Saves the teacher (semi_ema) as the ckpt `ema` entry after burn-in
        (reference ssod_trainer.py:393-409). `last.ckpt` also holds what
        resume needs: the optimizer state and, past seeding, the EMA."""
        st = self.state
        ema_src = st.semi_ema if self.teacher_seeded else st.ema
        student = module_variables(st.model)
        teacher = module_variables(ema_src.module)
        opt = extra = None
        if name == "last.ckpt":
            opt = self._optimizer_state()
            if self.teacher_seeded:
                extra = {"student_ema": {**module_variables(st.ema.module),
                                         "updates": st.ema.updates}}
        self.checkpointer.save(
            self.save_dir / "weights" / name,
            params=student["params"],
            batch_stats=student["batch_stats"],
            ema_params=teacher["params"],
            ema_batch_stats=teacher["batch_stats"],
            ema_updates=ema_src.updates,
            opt_state=opt,
            extra=extra,
            epoch=self.epoch if epoch is None else epoch,
            best_fitness=self.best_fitness,
            cfg_yaml=self.cfg.dump(),
        )
