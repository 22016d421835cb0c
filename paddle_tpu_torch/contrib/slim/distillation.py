"""Distillation (counterpart of paddle_tpu/contrib/slim/distillation.py):
L2Distiller, FSPDistiller and SoftLabelDistiller, each a loss over
(student, teacher) variable pairs.  Teacher and student are built in one
program (the teacher frozen by leaving its parameters out of the
optimizer's parameter_list), and each loss is composed of the port's
`layers`; FSP uses the `fsp` op."""
from __future__ import annotations

from ... import layers


class L2Distiller:
    """The mean-square error between a student and a teacher feature map."""

    def __init__(self, student_feature_map, teacher_feature_map,
                 distillation_loss_weight=1.0):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.weight = distillation_loss_weight

    def distiller_loss(self, student_var=None, teacher_var=None):
        s = student_var if student_var is not None else self.student_feature_map
        t = teacher_var if teacher_var is not None else self.teacher_feature_map
        diff = s - t
        return layers.reduce_mean(diff * diff) * self.weight


class FSPDistiller:
    """The L2 between the student's and the teacher's flow-of-solution-
    procedure matrices of feature-map pairs."""

    def __init__(self, student_pairs, teacher_pairs,
                 distillation_loss_weight=1.0):
        self.student_pairs = list(student_pairs)
        self.teacher_pairs = list(teacher_pairs)
        self.weight = distillation_loss_weight

    def distiller_loss(self):
        losses = []
        for (s0, s1), (t0, t1) in zip(self.student_pairs, self.teacher_pairs):
            sf = layers.fsp_matrix(s0, s1)
            tf = layers.fsp_matrix(t0, t1)
            diff = sf - tf
            losses.append(layers.reduce_mean(diff * diff))
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        return total * self.weight


class SoftLabelDistiller:
    """The cross entropy between temperature-softened teacher and student
    logits."""

    def __init__(self, student_feature_map=None, teacher_feature_map=None,
                 student_temperature=1.0, teacher_temperature=1.0,
                 distillation_loss_weight=1.0):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.student_temperature = student_temperature
        self.teacher_temperature = teacher_temperature
        self.weight = distillation_loss_weight

    def distiller_loss(self, student_var=None, teacher_var=None):
        s = student_var if student_var is not None else self.student_feature_map
        t = teacher_var if teacher_var is not None else self.teacher_feature_map
        s_soft = layers.softmax(s * (1.0 / self.student_temperature))
        t_soft = layers.softmax(t * (1.0 / self.teacher_temperature))
        ce = layers.cross_entropy(s_soft, t_soft, soft_label=True)
        return layers.reduce_mean(ce) * self.weight
