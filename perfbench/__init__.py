"""The benchmark of kalle_tpu_torch: one command runs one cell once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`perfbench/configs/<config>.json`) and a traffic mix
(`perfbench/traffic/<mix>.json`, whose `driver` names a module of
`perfbench/drivers/`). Per-layer metrics are readers in
`perfbench/metrics/<metric>.py`, operation and byte counts live in
`perfbench/flops/`, and the plain reference that decides `correct` in
`perfbench/reference/` with each cell's limits in
`perfbench/limits/<cell>.json`. Nothing here imports JAX or the JAX
package; the reference imports nothing of the program.
"""
