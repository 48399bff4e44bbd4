"""build.graph_patch_s: seconds of the graph build's reachability patch,
as the index records them (``build_stats["patch_s"]`` on the host clock,
the stage synchronised at its end), of the traced run's build."""


def read(run):
    ys = run.yardstick
    stats = ys.get("build_stats") if isinstance(ys, dict) else None
    return stats.get("patch_s") if stats else None
