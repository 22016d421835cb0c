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
    source, old, new = mutants.MUTANTS[name]
    src = _source(source)
    assert src.count(old) == 1
    assert old != new
    compile(mutants.check_code(source), name, "exec")

