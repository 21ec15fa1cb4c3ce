"""Static analysis for the port: the plan/StageGraph verifier and the
serving path's runtime checks.

Public surface:

  * :func:`repro_torch.analysis.verifier.check_logical` /
    :func:`~repro_torch.analysis.verifier.check_graph` /
    :func:`~repro_torch.analysis.verifier.check_exec` — the three verifier
    layers;
  * :func:`repro_torch.analysis.verifier.verify_plan` — lower + verify in
    one call;
  * :func:`repro_torch.analysis.runtime.runtime_assert` — the serving
    path's invariant checks (``RAVEN_ANALYSIS_ASSERTS``).

The registry checks, the concurrency lint and the ``python -m`` gate are
ROADMAP.md Queue 1 item 8's remainder, not ported yet.
"""
from repro_torch.analysis.rules import (  # noqa: F401
    AnalysisResult,
    Rule,
    VerificationWarning,
    Violation,
    rule_catalog,
)
from repro_torch.analysis.runtime import (  # noqa: F401
    RuntimeInvariantError,
    asserts_enabled,
    runtime_assert,
)
from repro_torch.analysis.verifier import (  # noqa: F401
    check_exec,
    check_graph,
    check_logical,
    resolve_verify_mode,
    verify_graph,
    verify_plan,
)
