"""The plain reference the benchmark judges the program's results by.

`sched.schedule` re-implements, in NumPy and from the manifests alone, the
kube-scheduler semantics the benchmark's cells use: NodeResourcesFit,
TaintToleration, NodeAffinity/nodeSelector, PodTopologySpread (DoNotSchedule
and ScheduleAnyway), the open-gpu-share filter, score and device pick, the
default score fold, and simon's pod ordering. `compare.judge` holds a
program's `simulate()` result against it. Nothing here imports the program
or JAX.
"""
