"""On the card: at the cell's own widths and batch, over a short window, the
program's numbers stay within the limits and the float8 control's do not."""

import pytest

from perfbench import harness


@pytest.mark.card
@pytest.mark.parametrize("cell", ["vt5-concat-mpdocvqa", "hivt5-mpdocvqa"])
def test_control_fails_where_the_program_passes(card, cell):
    sp = harness.spec(cell)
    sp.traffic["pool_docs"] = 2 * sp.traffic["block_docs"]
    r = harness.run(sp, 2**31 + 3, 2.0, False, control=True, log=lambda *a: None)
    assert r["correct"], r["checks"]
    limits = sp.cfg["limits"]
    assert any(v > limits[k] for k, v in r["control"].items()), r["control"]
