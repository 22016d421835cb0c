"""tools/port_attention_mutants.py edits copies of the kernel sources by
text: every mutant must find its anchor exactly once, or the tool would
break (or, worse, test an unbroken copy) on the card."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import port_attention_mutants as mutants  # noqa: E402


def _source(relpath):
    with open(os.path.join(ROOT, relpath)) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(mutants.MUTANTS))
def test_mutant_anchor_occurs_once_and_changes_the_source(name):
    for source, old, new in mutants.edits_of(name):
        src = _source(source)
        assert src.count(old) == 1
        assert old != new
        compile(mutants.check_code(source), name, "exec")
    for _, _, code in mutants.runs([name]):
        compile(code, name, "exec")



import port_bs_bwd_variants as bs_variants  # noqa: E402


@pytest.mark.parametrize("name", sorted(bs_variants.VARIANTS))
def test_bs_bwd_variant_anchor_occurs_once(name):
    """tools/port_bs_bwd_variants.py edits copies of attention_bwd_bs.cu by
    text too: each of a variant's anchors occurs exactly once."""
    src = _source(bs_variants.BS_BWD)
    for old, new in bs_variants.VARIANTS[name]:
        assert src.count(old) == 1 and old != new
