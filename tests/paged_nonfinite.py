"""Planted non-finite cases of paged attention, shared by the CPU parity
tests (against the JAX kernel) and the card's tests (the CUDA kernel
against its plain version).

The JAX kernel visits every listed page of a slot and adds ``p @ V`` with
p = 0 at masked positions, so a non-finite V value at a position masked
for a row makes that row's column NaN, a non-finite K value at a masked
position changes nothing, and values at visible positions propagate as
the plain version propagates them. :func:`plant` puts one case into
copies of numpy inputs and returns the NaN and inf masks the contract
gives.
"""
import numpy as np

CASES = ["finite", "masked_tail_nan", "past_page_inf", "masked_k_nan",
         "repeated_page", "row_split_inf"]


def plant(case, kp, vp, bt, pos, W, page):
    """Plant one non-finite case in copies of the store and block table
    -> (kp, vp, bt, nan, inf), ``nan``/``inf`` the (S, W, C) masks the
    contract gives. Per slot s, ``last`` is the last position any row
    sees and c = 3 s + 1 the column planted:
    masked_tail_nan: NaN in V at ``last + 1`` (the masked tail of the
    last visible page) -> column c NaN in every row;
    past_page_inf: +inf in V in the last listed page, wholly past the
    position -> column c NaN in every row;
    masked_k_nan: NaN across K's row at ``last + 1`` -> all finite;
    repeated_page: every entry past ``last``'s page lists page 0, whose
    row 1 holds +inf in V at column 1 -> column 1 NaN in every row of
    every slot with such an entry;
    row_split_inf: +inf in V at ``pos + 1``, masked for row 0 only ->
    row 0 NaN at column c, rows 1.. +inf there."""
    kp, vp, bt = kp.copy(), vp.copy(), bt.copy()
    S, mp = bt.shape
    C = kp.shape[1]
    nan = np.zeros((S, W, C), bool)
    inf = np.zeros((S, W, C), bool)
    for s in range(S):
        last = int(pos[s]) + W - 1
        c = (3 * s + 1) % C

        def row(t):
            return int(bt[s, t // page]) * page + t % page
        if case == "masked_tail_nan" and last + 1 < mp * page:
            vp[row(last + 1), c] = np.nan
            nan[s, :, c] = True
        elif case == "past_page_inf" and last // page + 1 < mp:
            vp[row((mp - 1) * page + s % page), c] = np.inf
            nan[s, :, c] = True
        elif case == "masked_k_nan" and last + 1 < mp * page:
            kp[row(last + 1)] = np.nan
        elif case == "repeated_page" and last // page + 1 < mp:
            bt[s, last // page + 1:] = 0
            vp[1, 1] = np.inf
            nan[s, :, 1] = True
        elif case == "row_split_inf" and pos[s] + 1 < mp * page:
            vp[row(int(pos[s]) + 1), c] = np.inf
            nan[s, 0, c] = True
            inf[s, 1:, c] = True
    return kp, vp, bt, nan, inf
