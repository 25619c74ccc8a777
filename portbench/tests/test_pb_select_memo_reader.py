"""The select_memo_hit_share reader on synthetic counter deltas: hits over
the selected series, and nothing where the program keeps no memo
counters."""

import pytest

from test_pb_readers import read


@pytest.mark.parametrize("hits,misses,share", [
    (95.0, 5.0, 95.0), (0.0, 12.0, 0.0), (7.0, 0.0, 100.0),
    (0.0, 0.0, None)])
def test_select_memo_hit_share_is_hits_over_selected_series(hits, misses,
                                                            share):
    c = {"filodb_select_memo_hits_total": hits,
         "filodb_select_memo_misses_total": misses}
    got = read("select_memo_hit_share", counters=c)
    assert got == (None if share is None else pytest.approx(share))
    # a program without the memo's counters (the parent's): nothing
    assert read("select_memo_hit_share",
                counters={"filodb_tile_builds_total": 3.0}) is None
