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
  - after_epoch (:319-419): the LabelMatch threshold refresh, cosine EMA
    decay, validation of the (semi-)EMA teacher, teacher saved as the
    ckpt `ema`
  - pseudo-label quality meters (:655-680), on the logged batches only
  - `SSOD.pseudo_label_type: LabelMatch` (`ssod/labelmatch.py`): every
    step's NMS (conf, class) before the warp is collected, and from the
    epoch that reaches both `burn_epochs` and `dynamic_thres_epoch` on
    each epoch end refreshes the per-class thresholds the next epoch's
    steps take; otherwise the thresholds are ignore_thres_high/low
  - `SSOD.extra_teachers` (:96-203): port checkpoints or reference `.pt`
    files (`utils/torch_import.py`), shape-matched, loaded into frozen
    eval-mode copies of the student's architecture (its detector without
    the discriminators), their classes mapped into `Dataset.names` by
    `SSOD.extra_teachers_class_names` (-1 drops a class); their pseudo
    labels merge with the EMA's in every step
  - `SSOD.use_ota`: the SSOD loss's SimOTA branch, at top_k 1 (the
    reference builds its SSOD assigner without top_k, ssod_loss.py:71-72)

Differences from the JAX trainer:
  - pseudo labels are copied to the host only on the batches it logs
    (every 50th), not on every step: the FairPseudoLabel path needs them
    nowhere else, and each copy waits for the card; under LabelMatch
    each step also copies its NMS (conf, class, valid), one small copy,
    which the JAX trainer makes on every step whatever the creator;
  - the endless labelled iterator iterates its loader again on each pass
    (`_cycle`); `itertools.cycle` keeps every batch of the first pass;
  - `resume` restores the state (the JAX SSOD trainer's build_optimizer
    never calls `_resume`), so `last.ckpt` holds the optimizer momentum
    and, past seeding, the student's EMA (the pseudo-label teacher) with
    its count as `student_ema`, beside the teacher (semi-EMA) as `ema`,
    and under LabelMatch its thresholds, class totals and uncollected
    scores (in the `optimizer` entry, float32 and float64 as they are).
Under `SSOD.debug` (with ground truth on the target set) the first two
SSOD batches of each epoch are plotted with their pseudo labels against
the labels (`plot_pseudo_vs_gt`, `pseudo_gt_e{epoch}_b{i}.png`, rank 0).
Not ported (NotImplementedError): the SSOD losses of the anchor-free
heads (ROADMAP Q1.12).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..data.datasets_ssod import create_target_dataloader
from ..eval.metrics import fitness
from ..losses.ssod_loss import SSODLossConfig
from ..models import build_model
from ..models.heads import head_model_type
from ..ops.augment_device import device_ssod_views, step_seed
from ..parallel.distributed import to_host
from ..ssod.labelmatch import LabelMatch
from ..ssod.quality import check_pseudo_label, check_pseudo_label_with_gt
from ..utils.checkpoint import load_module_variables, module_variables
from ..utils.torch_import import load_weights_into
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
        # dynamic per-class thresholds only under the LabelMatch creator
        # (reference ssod_trainer.py:320-323)
        self.use_labelmatch = str(cfg.SSOD.pseudo_label_type) == "LabelMatch"
        self.dynamic_thres_epoch = int(cfg.SSOD.dynamic_thres_epoch)
        self.label_match = None
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
        semi-EMA and `student_ema` the EMA, each with its count.
        LabelMatch's state waits for `_restore_label_match`."""
        super()._restore(ckpt)
        # LabelMatch's state is read in build_loss, where LabelMatch is made
        self._resumed_optimizer = ckpt.get("optimizer")
        if "student_ema" not in ckpt:
            return  # saved before seeding: `ema` is the EMA
        st, ent = self.state, ckpt["student_ema"]
        load_module_variables(st.semi_ema.module, ckpt["ema"])
        st.semi_ema.updates = st.ema.updates
        load_module_variables(st.ema.module, ent)
        st.ema.updates = int(ent["updates"])
        # a graceful stop in the seeding epoch re-runs it, seeding again
        self.teacher_seeded = self.start_epoch > self.burn_epochs

    def _restore_label_match(self):
        """LabelMatch's state from the resumed `last.ckpt`, read once the
        LabelMatch object exists (build_loss)."""
        opt = getattr(self, "_resumed_optimizer", None) or {}
        if "labelmatch" in opt:
            self.label_match.load_state_dict(opt["labelmatch"])
            if not self.is_main:  # rank 0's scores are every rank's
                self.label_match.drop_scores()

    def build_loss(self, cfg):
        super().build_loss(cfg)
        if head_model_type(self.spec.head) != "yolov5":
            raise NotImplementedError(
                f"the SSOD losses of the {self.spec.head!r} head are not "
                "ported (ROADMAP Q1.12: the JAX SSOD step has none); the "
                "port's SSOD trainer runs anchor heads")
        self.ssod_loss_cfg = SSODLossConfig.from_cfg(cfg, nl=self.spec.nl)
        # the per-class thresholds: FairPseudoLabel's fixed ones, or
        # LabelMatch's, refreshed per epoch (`_thresholds`)
        nc = self.spec.nc
        s = cfg.SSOD
        self.cls_thr_high = torch.full((nc,), float(s.ignore_thres_high),
                                       device=self.device)
        self.cls_thr_low = torch.full((nc,), float(s.ignore_thres_low),
                                      device=self.device)
        if self.use_labelmatch:
            self.label_match = LabelMatch(
                cfg, target_data_len=len(self.target_loader.ds),
                label_num_per_img=self.dataset.label_num_per_image,
                cls_ratio_gt=self.dataset.cls_ratio_gt)
            self._restore_label_match()

    def _load_extra_teachers(self, cfg):
        """(module, class map or None) per `SSOD.extra_teachers` entry:
        each port checkpoint (its `ema` entry if it has one) in a frozen
        eval-mode detector of the student's spec, without the
        discriminators (a checkpoint's own are not read); the class map
        from `SSOD.extra_teachers_class_names[i]` against `Dataset.names`,
        -1 for a name the dataset lacks (JAX ssod_trainer.py:146-167)."""
        names = [str(n) for n in cfg.Dataset.names]
        name_lists = list(cfg.SSOD.extra_teachers_class_names)
        spec = dataclasses.replace(self.spec, train_domain=False)
        out = []
        for i, path in enumerate(cfg.SSOD.extra_teachers):
            module = build_model(spec, device=self.device)
            load_weights_into(module, str(path))
            module = module.float().eval().requires_grad_(False)
            if self.device.type == "cuda":
                module = module.to(memory_format=torch.channels_last)
            cmap = None
            if i < len(name_lists) and name_lists[i]:
                cmap = torch.tensor(
                    [names.index(str(n)) if str(n) in names else -1
                     for n in name_lists[i]], dtype=torch.long,
                    device=self.device)
            out.append((module, cmap))
            LOGGER.info("loaded extra teacher %s", path)
        return out

    def build_step(self):
        cfg = self.cfg
        self.extra_teachers = (self._load_extra_teachers(cfg)
                               if cfg.SSOD.extra_teachers else [])
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
            extra_teachers=self.extra_teachers,
            use_ota=bool(cfg.SSOD.use_ota),
            # the reference's SSOD assigner is built without top_k: the
            # YOLOAnchorAssigner default 1 (ssod_loss.py:71-72)
            ota_top_k=1,
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
        if self.label_match is not None:
            # what a graceful stop in this epoch saves: it re-runs the epoch
            self._label_match_at_start = self.label_match.state_dict()
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
                self.meter.update(self._logged(parts))
                LOGGER.info("burn epoch %d it %d/%d %s", self.epoch, i,
                            self.nb, self.meter)
            if self._stop_requested():
                break

    def _thresholds(self):
        """The per-class (high, low) thresholds of this epoch's steps."""
        if self.label_match is None:
            return self.cls_thr_high, self.cls_thr_low
        lm = self.label_match
        return (torch.as_tensor(lm.cls_thr_high, device=self.device),
                torch.as_tensor(lm.cls_thr_low, device=self.device))

    def _train_with_unlabeled(self):
        semi_decay = self._semi_decay()
        thr_high, thr_low = self._thresholds()
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
                self.aug_gen.manual_seed(step_seed(2, ni, 1, self.rank))
                t_strong, t_labels, t_mask, t_weak, t_ms = device_ssod_views(
                    self.aug_gen, t_weak, t_labels.float(), t_mask,
                    self.ssod_hyp, max_out=int(self.cfg.Dataset.max_targets))
            else:
                t_strong, t_weak, t_ms = self._to_device(
                    tbatch["images"], tbatch["images_ori"], tbatch["M_s"])
                t_labels, t_mask = tbatch.get("labels"), tbatch.get("mask")
            self.state, out = self.ssod_step(
                self.state, s_imgs, s_labels, s_mask,
                t_strong, t_weak, t_ms, thr_high, thr_low, sched,
                semi_decay,
            )
            if self.label_match is not None:
                # every NMS detection's (conf, class) before the warp
                # (reference utils/labelmatch.py:283-299): one host copy
                nms = to_host(torch.stack(
                    [out.nms_conf, out.nms_cls, out.nms_valid.float()], -1))
                self.label_match.collect(
                    np.where(nms[..., 2] > 0, nms[..., 0], 0.0),
                    nms[..., 1])
            if self.cfg.SSOD.debug and i < 2 and self.target_with_gt:
                # pseudo-vs-GT mosaics on the strong view (reference
                # utils/self_supervised_utils.py:239-243)
                self._plot("plot_pseudo_vs_gt", lambda: (
                    to_host(t_strong), to_host(out.pseudo_labels),
                    to_host(out.pseudo_mask), to_host(t_labels),
                    to_host(t_mask),
                    self.save_dir / f"pseudo_gt_e{self.epoch}_b{i}.png"))
            if i % 50 == 0:
                metrics = self._logged(out.metrics)
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
            if self._stop_requested():
                break

    def after_epoch(self):
        lm = self.label_match
        if lm is not None:
            # under DDP: every rank's scores on every rank, so the ranks
            # derive the same thresholds; rank 0 alone keeps what is not
            # consumed (its last.ckpt holds them all)
            lm.gather()
            if self.epoch >= self.burn_epochs \
                    and self.epoch >= self.dynamic_thres_epoch:
                lm.update_epoch_cls_thr(max(self.epoch - self.burn_epochs,
                                            0))
                LOGGER.info("labelmatch thr_high[:5]=%s thr_low[:5]=%s",
                            np.round(lm.cls_thr_high[:5], 3),
                            np.round(lm.cls_thr_low[:5], 3))
            if not self.is_main:
                lm.drop_scores()
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
        resume needs: the optimizer state, LabelMatch's (as it stood at the
        epoch's start when a graceful stop saves, `epoch` given) and, past
        seeding, the EMA."""
        st = self.state
        ema_src = st.semi_ema if self.teacher_seeded else st.ema
        student = module_variables(st.model)
        teacher = module_variables(ema_src.module)
        opt = extra = None
        if name == "last.ckpt":
            opt = self._optimizer_state()
            if self.label_match is not None:
                opt["labelmatch"] = (self._label_match_at_start
                                     if epoch is not None
                                     else self.label_match.state_dict())
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
