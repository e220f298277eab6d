"""The mean-teacher SSOD train step and its burn-in step (counterpart of
`efficientteacher_tpu/train/ssod_step.py`; reference
trainer/ssod_trainer.py:587-680 train_instance):
  1. the EMA teacher's forward on the weak view, eval mode, no gradients
     (:595-606)
  2. FairPseudoLabel: NMS (the K1 kernel on the card) + the M-warp (:618)
  3. the student's forward on cat([labelled, strong unlabelled]) in train
     mode, so BatchNorm statistics span both halves (:623-626)
  4. supervised loss + SSOD loss * teacher_loss_weight (+ domain losses *
     da_weight); the SSOD loss is zeroed when no pseudo label survived
     (:628-649)
  5. accumulated Nesterov SGD; EMA <- student; semi-EMA <- EMA (:458-488)

The teacher is the primary EMA (the semi-EMA is for validation and
checkpoints). Thresholds and decays arrive per call, so epoch-boundary
updates need nothing rebuilt. Extra teachers (frozen eval-mode models of
the student's architecture, each with its class map) run on the weak view
beside the EMA, and their sets merge into the pseudo labels
(`create_pseudo_labels_multi`); `use_ota` swaps the SSOD loss for its
SimOTA branch (`compute_ssod_ota_loss`, JAX ssod_step.py:89-176).

`on_phase`, where a caller passes it, is called with a phase name after
each phase has been enqueued ("teacher", "extra_teachers" when there are
any, "pseudo_labels", "student_fwd_bwd", "optimizer"): a hook for timing,
e.g. by CUDA events.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..losses.domain_loss import domain_loss, target_loss
from ..losses.ssod_loss import (SSODLossConfig, compute_ssod_loss,
                                compute_ssod_ota_loss)
from ..losses.yolov5_loss import YoloV5LossConfig, compute_loss
from ..parallel.distributed import global_sum
from ..ssod.pseudo_label import (create_pseudo_labels,
                                 create_pseudo_labels_multi)
from ..utils.precision import autocast
from .optim import OptimizerConfig
from .supervised import (Schedule, apply_grads, detached, forward_train,
                         grads_of, to_input)
from .train_state import (EMAState, TrainState, bn_stats, create_train_state,
                          init_ema)


@dataclasses.dataclass
class SSODTrainState(TrainState):
    """TrainState + the teacher chain student -> EMA -> semi-EMA
    (reference ssod_trainer.py:485-487)."""

    semi_ema: Optional[EMAState] = None


def create_ssod_train_state(model: torch.nn.Module, oc: OptimizerConfig
                            ) -> SSODTrainState:
    base = create_train_state(model, oc, with_ema=True)
    return SSODTrainState(**{f.name: getattr(base, f.name)
                             for f in dataclasses.fields(base)},
                          semi_ema=init_ema(model))


class SSODBatchOut(NamedTuple):
    metrics: dict
    pseudo_labels: torch.Tensor  # (B, max_pl, 8)
    pseudo_mask: torch.Tensor    # (B, max_pl) bool
    pseudo_count: torch.Tensor   # () int64
    nms_conf: torch.Tensor       # (B, max_pl), before the warp
    nms_cls: torch.Tensor
    nms_valid: torch.Tensor


def _noop(_phase: str) -> None:
    return None


def _add_domain_losses(loss, parts, domain, bs_sup, weight):
    """+ (source-domain + target-domain loss) * weight over the
    discriminators' logits: the first bs_sup images are the source."""
    d_l = domain_loss([f[:bs_sup] for f in domain])
    t_l = target_loss([f[bs_sup:] for f in domain])
    return (loss + (d_l + t_l) * weight,
            {**parts, "d_loss": d_l, "t_loss": t_l})


def make_ssod_train_step(
        sup_cfg: YoloV5LossConfig, ssod_cfg: SSODLossConfig, anchors_grid,
        opt_cfg: OptimizerConfig, spec, *, nms_conf_thres: float,
        nms_iou_thres: float, max_pl: int, multi_label: bool,
        teacher_loss_weight: float, da_loss_weight: float,
        with_da_loss: bool, norm_scale: float = 255.0,
        compute_dtype: torch.dtype = torch.bfloat16, extra_teachers=None,
        use_ota: bool = False, ota_top_k: int = 10):
    """(state, sup_images, sup_labels, sup_mask, un_strong, un_weak, m_s,
    thr_high, thr_low, sched, semi_decay, on_phase=None) -> (state,
    SSODBatchOut). Images uint8 NHWC; anchors_grid (nl, na, 2) on the
    step's device. The model is the state's (an SSODModel).

    extra_teachers: (module, class map or None) pairs, the modules frozen
    in eval mode on the step's device (`SSODTrainer._load_extra_teachers`).
    use_ota / ota_top_k: the SSOD OTA loss and its dynamic-k candidates."""
    img_size, nc = spec.img_size, spec.nc
    extra_teachers = list(extra_teachers or [])

    def train_step(state: SSODTrainState, sup_images, sup_labels, sup_mask,
                   un_strong, un_weak, m_s, thr_high, thr_low,
                   sched: Schedule, semi_decay: float,
                   on_phase: Optional[Callable[[str], None]] = None):
        on_phase = on_phase or _noop
        bs_sup = sup_images.shape[0]

        # 1-2. the primary EMA's pseudo labels on the weak view
        teacher = state.ema.module
        tx = to_input(un_weak, compute_dtype, norm_scale)
        with torch.no_grad(), autocast(un_weak.device, compute_dtype):
            (decoded, _), _ = teacher(tx, decode=True, with_domain=False)
            on_phase("teacher")
            extra = [module(tx, decode=True)[0]
                     for module, _ in extra_teachers]
        nms_kw = dict(img_size=img_size, nc=nc, conf_thres=nms_conf_thres,
                      iou_thres=nms_iou_thres, max_pl=max_pl,
                      multi_label=multi_label)
        if extra_teachers:
            on_phase("extra_teachers")
            pl = create_pseudo_labels_multi(
                [decoded, *extra],
                [None, *(cmap for _, cmap in extra_teachers)], m_s,
                **nms_kw)
        else:
            pl = create_pseudo_labels(decoded, m_s, **nms_kw)
        on_phase("pseudo_labels")

        # 3-5. the student on labelled + strong images
        x = to_input(torch.cat([sup_images, un_strong]), compute_dtype,
                     norm_scale)
        raw, domain = forward_train(state.model, x, compute_dtype,
                                    with_domain=with_da_loss)
        sup_loss, sup_parts = compute_loss(
            [r[:bs_sup] for r in raw], sup_labels, sup_mask, anchors_grid,
            sup_cfg)
        un_raw = [r[bs_sup:] for r in raw]
        if use_ota:
            un_loss, un_parts = compute_ssod_ota_loss(
                un_raw, pl.labels, pl.mask, thr_high, thr_low, anchors_grid,
                spec.strides, img_size, ssod_cfg, top_k=ota_top_k)
        else:
            un_loss, un_parts = compute_ssod_loss(
                un_raw, pl.labels, pl.mask, thr_high, thr_low, anchors_grid,
                ssod_cfg)
        # no pseudo label in the whole (global, under DDP) batch
        invalid = global_sum(pl.mask.any().float()) == 0
        un_loss = torch.where(invalid, 0.0, un_loss)
        total = sup_loss + un_loss * teacher_loss_weight
        if with_da_loss:
            total, sup_parts = _add_domain_losses(
                total, sup_parts, domain, bs_sup, da_loss_weight)
        grads = grads_of(total, state)
        on_phase("student_fwd_bwd")
        apply_grads(state, grads, opt_cfg, sched, semi_decay)
        on_phase("optimizer")
        return state, SSODBatchOut(
            metrics=detached({**sup_parts, **un_parts, "total": total}),
            pseudo_labels=pl.labels, pseudo_mask=pl.mask,
            pseudo_count=pl.mask.sum(), nms_conf=pl.nms_conf,
            nms_cls=pl.nms_cls, nms_valid=pl.nms_valid)

    return train_step


def make_burn_in_train_step(
        sup_cfg: YoloV5LossConfig, anchors_grid, opt_cfg: OptimizerConfig,
        *, with_da_loss: bool = False, da_loss_weight: float = 0.0,
        norm_scale: float = 255.0,
        compute_dtype: torch.dtype = torch.bfloat16):
    """Burn-in: supervised only, on the SSOD model (with the domain losses
    against weak target images when `with_da_loss`; reference
    ssod_trainer.py:490-533). The EMA advances; the semi-EMA waits to be
    seeded at burn-in end.

    (state, images, labels, mask, target_images, sched, semi_decay) ->
    (state, parts); `target_images` is read only with `with_da_loss`, and
    `semi_decay` is not read (the JAX step's signature)."""

    def train_step(state: SSODTrainState, images, labels, mask,
                   target_images, sched: Schedule, semi_decay=None):
        bs_sup = images.shape[0]
        x = torch.cat([images, target_images]) if with_da_loss else images
        raw, domain = forward_train(
            state.model, to_input(x, compute_dtype, norm_scale),
            compute_dtype, with_domain=with_da_loss)
        loss, parts = compute_loss([r[:bs_sup] for r in raw], labels, mask,
                                   anchors_grid, sup_cfg)
        if with_da_loss:
            loss, parts = _add_domain_losses(loss, parts, domain, bs_sup,
                                             da_loss_weight)
        apply_grads(state, grads_of(loss, state), opt_cfg, sched)
        return state, detached(parts)

    return train_step


@torch.no_grad()
def seed_teacher_from_ema(state: SSODTrainState) -> SSODTrainState:
    """Burn-in end (reference ssod_trainer.py:305-316): the EMA's weights
    and statistics are copied into the student, and the semi-EMA starts as
    a copy of the EMA with its counter at 0. Copies, never aliases."""
    torch._foreach_copy_(state.params, state.ema.params)
    torch._foreach_copy_(bn_stats(state.model), state.ema.stats)
    state.semi_ema = EMAState(copy.deepcopy(state.ema.module))
    return state
