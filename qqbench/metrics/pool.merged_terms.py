"""pool.merged_terms: terms of a call's merged MSM (the port's counter
"serving.merged_terms" over the calls that reached the MSM)."""


def read(run):
    terms = run.program.get("counters", {}).get("serving.merged_terms")
    calls = run.program.get("timers", {}).get("serving.merged_msm.device")
    return terms / len(calls) if terms and calls else None
