"""lock-order-inversion: a cycle in the static lock-acquisition-order
graph.

Lockdep's core invariant, checked at lint time: if any code path
acquires lock B while holding lock A, then no path may acquire A while
holding B — two threads interleaving the two paths deadlock, each
holding what the other wants.  The graph is built from ``with <lock>``
nestings (lexical, plus acquisitions reachable through the project
call graph from calls made while a lock is held), so the inversion is
caught even when the two halves live in different functions or
modules.  A self-edge (re-acquiring a non-reentrant lock already
held) is the degenerate cycle and equally fatal.

The reference's runtime twin, ``analysis/tsan.py`` (``Config.tsan``),
arms only the fleet's locks (``pipeline/fleet.py``, A8b); it comes in
ROADMAP A8c, with ``race_soak``.
"""

from __future__ import annotations

from srtb_tpu_torch.analysis.core import Finding, ModuleSource, Project
from srtb_tpu_torch.analysis.rules import _concurrency as cc

RULE = "lock-order-inversion"
DOC = ("cycle in the with-block lock acquisition order graph "
       "(deadlock when threads interleave)")


def _findings(project: Project) -> dict[str, list[Finding]]:
    """One finding per acquisition-order cycle, anchored at the
    cycle's first edge site (computed once per project, emitted by the
    module that owns the anchor)."""
    cached = getattr(project, "_lock_order_findings", None)
    if cached is not None:
        return cached
    ana = cc.analysis(project)
    by_mod: dict[str, list[Finding]] = {}
    for scc in ana.cycles():
        inside = sorted(
            (a, b) for (a, b) in ana.edges
            if a in scc and b in scc)
        # anchor: the first edge by file/line, deterministic
        def site(e):
            mod, node, _ctx, _note = ana.edges[e]
            return (mod.rel, node.lineno, node.col_offset)
        inside.sort(key=site)
        a, b = inside[0]
        mod, node, ctx, note = ana.edges[(a, b)]
        chain = " -> ".join(cc.pretty(k) for k in scc + [scc[0]])
        others = "; ".join(
            f"'{cc.pretty(x)}' before '{cc.pretty(y)}' at "
            f"{ana.edges[(x, y)][0].rel}:{ana.edges[(x, y)][1].lineno}"
            f" ({ana.edges[(x, y)][3]})"
            for (x, y) in inside[1:3])
        msg = (f"lock acquisition order cycle [{chain}]: "
               f"'{cc.pretty(a)}' is held while taking "
               f"'{cc.pretty(b)}' ({note}), but the reverse order "
               f"also exists ({others or 'self-edge'}) — pick one "
               "global order or record the exclusivity argument in "
               "the baseline")
        by_mod.setdefault(mod.rel, []).append(Finding(
            RULE, mod.path, mod.rel, node.lineno, node.col_offset,
            msg, ctx, mod.line_text(node.lineno)))
    project._lock_order_findings = by_mod
    return by_mod


def check(project: Project, mod: ModuleSource):
    yield from _findings(project).get(mod.rel, ())
