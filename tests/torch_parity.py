"""Shared check for the fusion_tpu_torch parity tests: ranked lists equal up
to the order of ids whose reference scores tie."""

import numpy as np


def assert_ranked_match(got_ids, got_scores, want_ids, want_scores, atol, cut_ties=False):
    """Scores agree within ``atol``; ids agree position by position, except
    that ids whose reference scores lie within ``atol`` of each other (a run
    of near-ties, which a different summation order may reorder) must match
    as sets.  ``cut_ties``: the depth cut may fall inside a run of near-ties,
    whose members past the cut neither list shows, so the run that reaches
    the last position is held to its scores only."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    got_scores, want_scores = np.asarray(got_scores), np.asarray(want_scores)
    assert got_ids.shape == want_ids.shape, (got_ids.shape, want_ids.shape)
    np.testing.assert_allclose(got_scores, want_scores, atol=atol, rtol=0)
    for row in range(want_ids.shape[0]):
        s = want_scores[row]
        start = 0
        for end in range(1, len(s) + 1):
            run_ends = end == len(s) or not (
                s[end] == s[end - 1] or abs(s[end] - s[end - 1]) <= atol
            )
            if run_ends and not (cut_ties and end == len(s)):
                assert set(got_ids[row, start:end]) == set(want_ids[row, start:end]), (
                    row, got_ids[row], want_ids[row], s,
                )
            if run_ends:
                start = end
