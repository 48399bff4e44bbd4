"""recall_at_10: over every query answered in the window, the share of
the reference's exact top-10 ids found among the ids returned."""


def read(run):
    return run.recall
