"""Dygraph LR decay schedules (counterpart of
paddle_tpu/dygraph/learning_rate_scheduler.py; reference
python/paddle/fluid/dygraph/learning_rate_scheduler.py): small stateful
objects passed as an optimizer's learning_rate; `step()` advances and
returns the current value (the eager optimizers call them per update)."""
from __future__ import annotations

import math


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step
        self.dtype = dtype

    def __call__(self):
        val = self.step()
        self.step_num += self.step_size
        return val

    def create_lr_var(self, lr):
        """reference wraps the float in a [1] variable; eager mode uses the
        scalar directly."""
        return float(lr)

    def step(self):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.create_lr_var(self.values[i])
        return self.create_lr_var(self.values[len(self.boundaries)])


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        t = self.step_num / self.decay_steps
        if self.staircase:
            t = math.floor(t)
        return self.create_lr_var(self.learning_rate * math.exp(-self.decay_rate * t))


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        t = self.step_num / self.decay_steps
        if self.staircase:
            t = math.floor(t)
        return self.create_lr_var(self.learning_rate * (self.decay_rate ** t))


class InverseTimeDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        t = self.step_num / self.decay_steps
        if self.staircase:
            t = math.floor(t)
        return self.create_lr_var(self.learning_rate / (1.0 + self.decay_rate * t))


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_learning_rate = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        n = self.step_num
        steps = self.decay_steps
        if self.cycle:
            div = math.ceil(max(n, 1) / steps)
            steps = steps * max(div, 1)
        else:
            n = min(n, steps)
        frac = (1.0 - n / steps) ** self.power
        return self.create_lr_var(
            (self.learning_rate - self.end_learning_rate) * frac
            + self.end_learning_rate)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        epoch = math.floor(self.step_num / self.step_each_epoch)
        return self.create_lr_var(
            self.learning_rate * 0.5 * (math.cos(epoch * math.pi / self.epochs) + 1))


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        n = max(self.step_num, 1)
        a = n ** -0.5
        b = (self.warmup_steps ** -1.5) * n
        return self.create_lr_var((self.d_model ** -0.5) * min(a, b))
