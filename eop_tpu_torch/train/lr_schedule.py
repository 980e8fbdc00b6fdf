"""LR schedules: functions of the iteration (counterpart of
``eop_tpu/train/lr_schedule.py``, whose arithmetic this copies): ``cos``,
``warmcos``, ``yoloxwarmcos`` (quadratic warmup, cosine, then a constant
``min_lr`` floor during the no-aug tail), ``yoloxsemiwarmcos`` and
``multistep``.  Plain float -> float; the train step asks the optimizer's
schedule for the rate of each update.
"""

from __future__ import annotations

import math
from typing import Sequence


def cos_lr(lr: float, total_iters: int):
    def schedule(it):
        return lr * 0.5 * (1.0 + math.cos(math.pi * it / total_iters))

    return schedule


def warm_cos_lr(lr: float, total_iters: int, warmup_total_iters: int,
                warmup_lr_start: float = 1e-6):
    def schedule(it):
        if it <= warmup_total_iters:
            return (lr - warmup_lr_start) * it / float(
                warmup_total_iters
            ) + warmup_lr_start
        return lr * 0.5 * (
            1.0
            + math.cos(
                math.pi
                * (it - warmup_total_iters)
                / (total_iters - warmup_total_iters)
            )
        )

    return schedule


def yolox_warm_cos_lr(
    lr: float,
    min_lr_ratio: float,
    total_iters: int,
    warmup_total_iters: int,
    warmup_lr_start: float = 0.0,
    no_aug_iter: int = 0,
):
    """Quadratic warmup, cosine, then the min_lr floor in the no-aug tail."""
    min_lr = lr * min_lr_ratio

    def schedule(it):
        if it <= warmup_total_iters:
            return (lr - warmup_lr_start) * pow(
                it / float(warmup_total_iters), 2
            ) + warmup_lr_start
        if it >= total_iters - no_aug_iter:
            return min_lr
        return min_lr + 0.5 * (lr - min_lr) * (
            1.0
            + math.cos(
                math.pi
                * (it - warmup_total_iters)
                / (total_iters - warmup_total_iters - no_aug_iter)
            )
        )

    return schedule


def yolox_semi_warm_cos_lr(
    lr: float,
    min_lr_ratio: float,
    warmup_lr_start: float,
    total_iters: int,
    normal_iters: int,
    no_aug_iters: int,
    warmup_total_iters: int,
    semi_iters: int,
    iters_per_epoch: int,
    iters_per_epoch_semi: int,
):
    """Semi-supervised variant."""
    min_lr = lr * min_lr_ratio

    def schedule(it):
        if it <= warmup_total_iters:
            return (lr - warmup_lr_start) * pow(
                it / float(warmup_total_iters), 2
            ) + warmup_lr_start
        if it >= normal_iters + semi_iters:
            return min_lr
        if it <= normal_iters:
            return min_lr + 0.5 * (lr - min_lr) * (
                1.0
                + math.cos(
                    math.pi
                    * (it - warmup_total_iters)
                    / (total_iters - warmup_total_iters - no_aug_iters)
                )
            )
        return min_lr + 0.5 * (lr - min_lr) * (
            1.0
            + math.cos(
                math.pi
                * (
                    normal_iters
                    - warmup_total_iters
                    + (it - normal_iters)
                    * iters_per_epoch
                    * 1.0
                    / iters_per_epoch_semi
                )
                / (total_iters - warmup_total_iters - no_aug_iters)
            )
        )

    return schedule


def multistep_lr(lr: float, milestones: Sequence[int], gamma: float = 0.1):
    def schedule(it):
        return lr * pow(gamma, len([m for m in milestones if m <= it]))

    return schedule


class LRScheduler:
    """Name-dispatched scheduler factory."""

    def __init__(self, name: str, lr: float, iters_per_epoch: int,
                 total_epochs: int, **kwargs):
        self.lr = lr
        self.iters_per_epoch = iters_per_epoch
        self.total_epochs = total_epochs
        self.total_iters = iters_per_epoch * total_epochs
        k = kwargs
        if name == "cos":
            self.lr_func = cos_lr(lr, self.total_iters)
        elif name == "warmcos":
            self.lr_func = warm_cos_lr(
                lr, self.total_iters,
                iters_per_epoch * k.get("warmup_epochs", 5),
                k.get("warmup_lr_start", 1e-6),
            )
        elif name == "yoloxwarmcos":
            self.lr_func = yolox_warm_cos_lr(
                lr, k.get("min_lr_ratio", 0.05), self.total_iters,
                iters_per_epoch * k.get("warmup_epochs", 5),
                k.get("warmup_lr_start", 0.0),
                iters_per_epoch * k.get("no_aug_epochs", 15),
            )
        elif name == "yoloxsemiwarmcos":
            warmup_total_iters = iters_per_epoch * k.get("warmup_epochs", 5)
            normal_iters = iters_per_epoch * k["semi_epoch"]
            semi_iters = k["iters_per_epoch_semi"] * (
                total_epochs - k["semi_epoch"] - k.get("no_aug_epochs", 15)
            )
            self.lr_func = yolox_semi_warm_cos_lr(
                lr, k.get("min_lr_ratio", 0.05),
                k.get("warmup_lr_start", 0.0),
                self.total_iters, normal_iters,
                iters_per_epoch * k.get("no_aug_epochs", 15),
                warmup_total_iters, semi_iters, iters_per_epoch,
                k["iters_per_epoch_semi"],
            )
        elif name == "multistep":
            milestones = [
                int(self.total_iters * m / total_epochs)
                for m in k.get("milestones", [])
            ]
            self.lr_func = multistep_lr(lr, milestones, k.get("gamma", 0.1))
        else:
            raise ValueError(f"Scheduler version {name} not supported.")

    def update_lr(self, iters: int) -> float:
        return self.lr_func(iters)
