"""graph.new_slots_pct: the share of the walk's candidate slots that held
a new row to score, over every slot of every round of the captured calls
(the program's ``graph_search_slots_total``: ``new`` over ``new``,
``dup``, ``visited`` and ``sentinel``, counted while its ranges are
emitted and never in a warm-up). The rest are rounds' work on nothing."""

from benchmark import graph_spans


def read(run):
    slots = graph_spans.slots_by_kind()
    if not slots:
        return None
    return 100.0 * slots.get("new", 0) / sum(slots.values())
