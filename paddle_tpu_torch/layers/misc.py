"""The in-program beam search layers and the tensor layers the beam decode
uses (counterpart of part of paddle_tpu/layers/misc.py): `beam_search`,
`beam_search_decode`, `key_padding_bias`, `logical_and`, `logical_or`,
`logical_not` and `expand`."""
from __future__ import annotations

from ..core.layer_helper import LayerHelper
from .nn import _out


def beam_search(logits, seqs, scores, finished, step_idx, beam_size, end_id, name=None):
    """One beam step over static [b, k] state; writes seqs, scores and
    finished in place, so they carry through a surrounding `While`."""
    helper = LayerHelper("beam_search", name=name)
    helper.append_op(
        "beam_search",
        inputs={"Logits": [logits.name], "Seqs": [seqs.name], "Scores": [scores.name],
                "Finished": [finished.name], "StepIdx": [step_idx.name]},
        outputs={"SelectedSeqs": [seqs.name], "SelectedScores": [scores.name],
                 "FinishedOut": [finished.name]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id)},
    )
    return seqs, scores, finished


def beam_search_decode(seqs, scores, end_id, length_penalty=0.0, name=None):
    """The best beam of each row: (ids [b, L], score [b])."""
    helper = LayerHelper("beam_search_decode", name=name)
    b, k, L = seqs.shape
    ids = _out(helper, seqs.dtype, shape=(b, L))
    best = _out(helper, "float32", shape=(b,))
    helper.append_op(
        "beam_search_decode",
        inputs={"Seqs": [seqs.name], "Scores": [scores.name]},
        outputs={"SentenceIds": [ids.name], "SentenceScores": [best.name]},
        attrs={"end_id": int(end_id), "length_penalty": float(length_penalty)},
    )
    return ids, best


def key_padding_bias(mask, name=None):
    """[b, Tk] 0/1 key mask -> additive [b, 1, 1, Tk] pre-softmax bias."""
    helper = LayerHelper("key_padding_bias", name=name)
    out = _out(helper, "float32")
    helper.append_op("key_padding_bias", inputs={"X": [mask.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def logical_and(x, y, out=None, name=None):
    helper = LayerHelper("logical_and", name=name)
    if out is None:
        out = _out(helper, "bool", shape=x.shape)
    helper.append_op("logical_and", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def logical_or(x, y, out=None, name=None):
    helper = LayerHelper("logical_or", name=name)
    if out is None:
        out = _out(helper, "bool", shape=x.shape)
    helper.append_op("logical_or", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    if out is None:
        out = _out(helper, "bool", shape=x.shape)
    helper.append_op("logical_not", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    shape = None
    if x.shape is not None:
        shape = tuple(d * t if d is not None and d >= 0 else d for d, t in zip(x.shape, expand_times))
    out = _out(helper, x.dtype, shape=shape)
    helper.append_op("expand", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"expand_times": [int(t) for t in expand_times]})
    return out
