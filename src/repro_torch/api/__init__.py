"""The experiment API of the port, as ``repro.api`` exports it: the
declarative ``ExperimentSpec``, the ``Trainer`` protocol and its
registry, the resume guard and run-spec storage, policy serving (a
server is a spec plus a carry), and sweeps (a sweep is a list of specs,
its same-except-seed runs packed into population fleets).

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
from repro_torch.api.sweep import (MANIFEST_FILENAME, Fleet, SweepRun,
                                   SweepSpec, expand, pack, run_sweep,
                                   sweep_compat_diff)
from repro_torch.api.trainers import (TRAINERS, Trainer, build_packed_fleet,
                                      build_trainer, register_trainer)

__all__ = [
    # spec surface
    "ExperimentSpec", "ScheduleSpec", "AlgoSpec", "CheckpointSpec",
    "MetricsSpec", "MODES",
    # trainer surface
    "Trainer", "TRAINERS", "register_trainer", "build_trainer",
    # resume-compatibility guard
    "SpecCompatError", "spec_compat_diff", "check_resume_compat",
    "save_run_spec", "load_run_spec", "RUN_SPEC_FILENAME",
    # serving surface (policy_client holds the simulated clients)
    "ServeSpec", "PolicyServer", "LoadedPolicy", "POLICIES",
    "load_policy", "make_server",
    # sweep surface (a sweep is a list of specs)
    "SweepSpec", "SweepRun", "Fleet", "MANIFEST_FILENAME",
    "expand", "pack", "run_sweep", "sweep_compat_diff",
    "build_packed_fleet",
]
