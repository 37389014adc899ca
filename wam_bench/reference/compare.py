"""The comparisons that decide ``correct``: what the program decoded
against what was sent.  Every comparison here is exact (limit 0)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


# bytes a lost message's search looks past where it was due: the most a
# 0.5 s idle gap at 300 baud could decode as stray bytes, and some
SLACK = 16


def compare_stream(decoded: bytes, messages: Sequence[bytes],
                   cycles: int) -> Tuple[int, int, int]:
    """One channel of a cyclic stream: ``decoded`` is everything the
    program decoded over ``cycles`` plays of a cycle carrying
    ``messages`` in order.  Each message is looked for, whole, from where
    the previous one ended, up to ``SLACK`` bytes further on.  Returns
    (messages due, messages lost, stray bytes): a message that is not
    found is lost; a byte that belongs to no message found is stray.
    Both are 0 exactly when ``decoded`` is the messages' concatenation."""
    pos = lost = due = stray = 0
    for _ in range(cycles):
        for m in messages:
            due += 1
            p = decoded.find(m, pos, pos + len(m) + SLACK)
            if p < 0:
                lost += 1
            else:
                stray += p - pos
                pos = p + len(m)
    stray += len(decoded) - pos
    return due, lost, stray


def failed_rows(got: Sequence[Optional[bytes]],
                want: Sequence[bytes]) -> List[int]:
    """Answers one by one: the rows of ``want`` whose answer is missing
    (None, or past the end of ``got``) or differs."""
    return [i for i, w in enumerate(want) if i >= len(got) or got[i] != w]

