"""Static analysis for the port: the plan/StageGraph verifier, the serving
path's runtime checks, the registry audit and the concurrency lint.

Public surface:

  * :func:`repro_torch.analysis.verifier.check_logical` /
    :func:`~repro_torch.analysis.verifier.check_graph` /
    :func:`~repro_torch.analysis.verifier.check_exec` — the three verifier
    layers;
  * :func:`repro_torch.analysis.verifier.verify_plan` — lower + verify in
    one call;
  * :func:`repro_torch.analysis.runtime.runtime_assert` — the serving
    path's invariant checks (``RAVEN_ANALYSIS_ASSERTS``);
  * :func:`repro_torch.analysis.registry_check.check_registry` — the model
    lifecycle and fault-tolerance state replayed from its evidence;
  * :func:`repro_torch.analysis.concurrency.lint_repo` — lock-discipline and
    forbidden-pattern lint over the port's sources;
  * ``python -m repro_torch.analysis [--device cpu]`` — all of them as a CI
    gate, on the card unless asked otherwise.
"""
from repro_torch.analysis.rules import (  # noqa: F401
    AnalysisResult,
    Rule,
    VerificationWarning,
    Violation,
    rule_catalog,
)
from repro_torch.analysis.concurrency import lint_repo, lint_source  # noqa: F401
from repro_torch.analysis.registry_check import (  # noqa: F401
    check_fault_tolerance,
    check_registry,
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
