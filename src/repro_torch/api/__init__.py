"""The experiment API of the port, as ``repro.api`` exports it: the
declarative ``ExperimentSpec``, the trainer registry, the resume guard
and run-spec storage, and policy serving (a server is a spec plus a
carry). Every execution mode runs, population (the default) included;
sweeps are ROADMAP.md queue 1 item 9.

    from repro_torch.api import ExperimentSpec, build_trainer

    trainer = build_trainer(spec, device="cuda")
    carry = trainer.init_carry()
    carry, metrics = trainer.cycle(carry)  # metrics lead with replicas
"""

from repro_torch.api.serve import (POLICIES, LoadedPolicy, PolicyServer,
                                   ServeSpec, load_policy, make_server)
from repro_torch.api.spec import (MODES, RUN_SPEC_FILENAME, AlgoSpec,
                                  CheckpointSpec, ExperimentSpec, MetricsSpec,
                                  ScheduleSpec, SpecCompatError,
                                  check_resume_compat, load_run_spec,
                                  save_run_spec, spec_compat_diff)
from repro_torch.api.trainers import TRAINERS, build_trainer, register_trainer

__all__ = [
    # spec surface
    "ExperimentSpec", "ScheduleSpec", "AlgoSpec", "CheckpointSpec",
    "MetricsSpec", "MODES",
    # trainer surface
    "TRAINERS", "register_trainer", "build_trainer",
    # resume-compatibility guard
    "SpecCompatError", "spec_compat_diff", "check_resume_compat",
    "save_run_spec", "load_run_spec", "RUN_SPEC_FILENAME",
    # serving surface (policy_client holds the simulated clients)
    "ServeSpec", "PolicyServer", "LoadedPolicy", "POLICIES",
    "load_policy", "make_server",
]
