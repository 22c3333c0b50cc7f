"""``1 - busy / window`` over the traced span, busy the union of the
kernel, copy and memset intervals; the mean over ranks.  None where the
trace holds no device operation."""


def read(run):
    shares = [b / w for b, w in run.busy if w > 0]
    if not shares or not any(shares):
        return None
    return 100 * (1 - sum(shares) / len(shares))
