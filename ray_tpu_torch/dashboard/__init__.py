"""Cluster dashboard: REST API + single-page web UI.

Analog of the reference's dashboard head (``python/ray/dashboard/head.py:61``)
and its per-domain modules (actor/node/job/metrics/state). Re-designed for
this runtime: one detached actor hosts an aiohttp server whose endpoints
read the GCS through the same state API users script against
(``ray_tpu_torch.util.state``), so the dashboard is a pure consumer of public
surface — the reference's layering invariant (SURVEY.md §1).
"""

from .head import (DashboardActor, get_dashboard_url, start_dashboard,
                   stop_dashboard)

__all__ = ["DashboardActor", "start_dashboard", "stop_dashboard",
           "get_dashboard_url"]
