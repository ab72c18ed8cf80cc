"""itl_p95_ms.moe: the statistic of `itl_p95_ms`, read in a traced run's
window (which runs as a plain run's does), as a per-layer metric of a cell
whose tail the host's dispatch sways: a decode step's dispatch takes about
as long on the host as the step does on the card."""

from portbench import readers


def read(rec):
    return readers.p95(rec.get("token_gaps_ms"))
