"""pool.replay_ms: a service call less its merged MSM, per call (the port's
own timers "serving.verify_wire" and "serving.merged_msm.device")."""

from qqbench.readers import timer_ms


def read(run):
    call, msm = timer_ms(run, "serving.verify_wire"), timer_ms(run, "serving.merged_msm.device")
    if call is None or msm is None:
        return None
    n_call = len(run.program["timers"]["serving.verify_wire"])
    n_msm = len(run.program["timers"]["serving.merged_msm.device"])
    return call - msm * n_msm / n_call
