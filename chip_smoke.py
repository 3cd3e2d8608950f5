#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's closed autoscaling loops and its training
loads once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU, nvcc
and g++:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device        — the card's name and power limit as nvidia-smi reports them.
2. build         — nvcc builds the GEMM (ops/csrc/matmul.cu), the flash
                   attention forward (ops/csrc/flash_attention.cu) and its
                   backward (ops/csrc/flash_attention_bwd.cu), each as bf16
                   and as f16, and their f32 sources (matmul_f32.cu,
                   flash_attention_f32.cu, flash_attention_bwd_f32.cu), g++
                   the exporter core from cpp/exporter, all ten at once; the
                   GEMM's tile configuration, its registers by warpgroup role
                   and its shared memory beside ptxas's report; the flash
                   forward's registers and spills for each instantiation
                   (head_dim 64 and 128 by one or two consumer warpgroups,
                   256, 384 and 512 by one) beside its threads, stages,
                   CTAs an SM, shared memory, chunks and K/V rows, and the
                   backward's (dQ and dK/dV at head_dim 64 to 512) beside
                   its threads, stages, shared memory, setmaxnreg counts,
                   chunks and streamed rows, in bf16 and in f16; the f32
                   kernels' registers and spills beside their
                   configuration, and the f32 backward's cluster kernels'
                   beside the clusters of 4 and 8 CTAs the card holds at
                   once (cudaOccupancyMaxActiveClusters).
3. parity        — the GEMM against its plain PyTorch version at six shapes,
                   among them N = 128 mod 256 and K = 128, in bf16, f16
                   and f32 (f32 at the JAX package's bar, 1e-3); an f64,
                   mixed or unaligned operand must raise.
4. timing        — the GEMM at 4096^3 beside its bound, the plain version and
                   torch.matmul (a yardstick the port never calls), in
                   bf16, f16 and f32 (the bound at the dtype's peak).
5. loadgen       — MatmulLoadGen on the GEMM tracks the commanded duty cycle,
                   launches the kernel once per product, and sustains more
                   than 44% of the card's peak at full duty (the tensor-core
                   HPA's band edge).
6. profile       — one full-length matmul burst under torch.profiler: one
                   GEMM and one renorm a product, device time by kernel and
                   the device's idle share.
7. loop          — the headline loop, as bench.py runs it: loadgen →
                   TorchDeviceSource → ExporterDaemon over HTTP → Scraper →
                   tpu-test rules → adapter → HPA on tpu_test_tensorcore_avg
                   (the GEMM's MFU) must scale 1 → 4 within the 60 s budget;
                   then the load drops to 0.08 devices and the drain back to
                   one replica must end within bench.py's 255 s with no flap.
7b. overshoot    — bench.py's overshoot probe on the headline loop: one
                   device of load (a need of 3 replicas) on the duty-cycle
                   average; no replica beyond 3 (bench.py's bar on a chip),
                   and what each sync read.
8. nvml          — NVML read from this process: the NVML device of the
                   generator's torch device found by UUID (never index 0
                   assumed); exporter/nvml.py's struct layouts against a probe
                   compiled with the card's nvml.h; with the generator idle
                   and the card's power settled, NvmlSource beside
                   nvidia-smi (total within 1 MiB, used
                   within 256 MiB, temperature within 3 °C, power within
                   25 W); the mean duty cycle over 3 s of sweeps at full duty
                   at least 90, and at knob 0.25 within 15 points of the
                   generator's own; tensorcore_util always None; GPM's
                   support and, where served, its DRAM bandwidth; a kubelet
                   ListPodResourcesResponse naming the card's UUID and a
                   plain index under nvidia.com/gpu, whose UUID must resolve
                   to the card's NVML index.
9. node_loop     — the headline loop through the node exporter
                   (run_node_headline_trial): NvmlSource and the kubelet
                   attribution decoded in nvml → ExporterDaemon, merging the
                   generator's self-report from a temporary directory → HTTP
                   → Scraper → HPA on tpu_test_tensorcore_avg must scale 1 → 4
                   within the 60 s budget; /metrics during the dwell carries
                   the power, temperature, tensor-core and duty-cycle
                   families for the real pod.
10. flash_parity — the flash kernel against its plain version on views of
                   one fused QKV product: the serve prefill's shape (causal
                   and not, with the logsumexp), the llm training shape with
                   the logsumexp, one KV tile (seq 64), seq 192 causal and
                   not on one and on two consumer warpgroups, head dim 64
                   on each over ten K/V tiles (each ring wraps), and the
                   long timed shape with the logsumexp; at head_dim 256 the
                   prefill (b8 s512 h8) causal with and without the
                   logsumexp, the training shape (b1 s2048 h8) with it, seq
                   192 causal and not, and ten K/V tiles; each output within
                   0.02 absolute and its error's RMS within a bar of its
                   own; then f16 at the same bars and f32 at the JAX
                   package's (2e-3) at the prefill, training, head_dim 64
                   and 256 shapes; then the chunked tilings at head_dim 384
                   and 512 in bf16 and f16: the prefill (b8 s512 h4, bf16),
                   the training shape (b1 s2048 h4) with the logsumexp,
                   seq 192 causal and not, and 20 K/V tiles (seq 640);
                   off-envelope operands (f64, head_dim 640 and f32 at 512
                   among them), an unknown split and two warpgroups past
                   head_dim 128 or in f32 must raise.
11. flash_timing — the flash kernel at the prefill's shape, at the llm
                   training shape with the logsumexp on fused-QKV views (as
                   the transformer calls it), at a long one, and at head_dim
                   256's prefill and training shape, beside its bound, the
                   plain version and scaled_dot_product_attention (a
                   yardstick the port never calls; the backend its dispatch
                   chose named), in turns; and each shape on
                   each consumer-warpgroup tiling of its head_dim; then the
                   prefill and training shapes at head_dim 128 and 256 in
                   f16 and f32, the bound at the dtype's peak, SDPA in the
                   dtype; and at head_dim 384 and 512 the prefill (b8 s512
                   h4) and the training shape (b1 s2048 h4) in bf16, the
                   training shape in f16 (SDPA's efficient backend there:
                   cuDNN's stops at 256).
11b. dwell       — bench.py's two rate blocks through utils/dwell.py:
                   trial.measure_attention_rates() (the flash forward and
                   reference_attention, each one CUDA graph of 400 causal
                   applications at b2 s4096 h8 d128 bf16, replayed once and
                   wall-clock timed to a scalar read) and
                   trial.measure_kernel_rates() (MatmulLoadGen's dwell at
                   4096^2 through torch.matmul and the GEMM, 2000 products,
                   and torch.matmul at 8192^2, 500).  First each attention
                   chain, four applications captured and replayed, is held
                   against the same four applied eagerly: the flash chain
                   bit for bit, the naive within 0.06 of its RMS.  Both
                   dicts are printed with the card's name and power limit.
12. serve_parity — at the shipped serve sizes in bf16: prefill against
                   stepwise decode, and the CUDA-graph burst against the same
                   burst run eagerly, bit for bit.
13. serve_loadgen— DecodeLoadGen at the shipped sizes: burst times (graph and
                   eager), token rates, bandwidth and the saturated signal's
                   headroom over the serve target.
14. serve_profile— one graph burst under torch.profiler: device time by
                   kernel, the flash kernel once per layer, the idle share.
15. serve_loop   — the serve loop: DecodeLoadGen → TorchDeviceSource →
                   ExporterDaemon → Scraper → tpu-serve rule → adapter → the
                   shipped serve HPA must scale 1 → 4 on tpu_serve_hbm_bw_avg
                   within the 60 s budget.
16. flash_bwd_parity — the dQ and dK/dV kernels against their plain versions
                   at the llm training shape (causal and not), seq 192 with
                   three heads, head_dim 64 over ten tiles a side (each
                   ring wraps), and at head_dim 256 the llm shape of a
                   2048-wide model (b1 s2048 h8) causal and not and seq
                   192, on views of one fused QKV product; in f16 at the
                   same bars and in f32 at the JAX package's (2e-4) at
                   those shapes and seq 192 not causal; at head_dim 384 and
                   512 in bf16 and f16 the llm shape of 4 heads causal and
                   not, seq 192 causal and not and 20 streamed tiles (seq
                   640); the autograd Function's gradients against autograd
                   through the plain forward at the llm shape, in bf16 and
                   in f32; off-envelope operands (f64, head_dim 640 and f32
                   at 512 among them) must raise.
17. flash_bwd_timing — both backward kernels (and the training forward) at the
                   llm shape, at a long one and at the llm shape at head_dim
                   256, beside their bounds, their plain versions and
                   scaled_dot_product_attention's backward (a yardstick the
                   port never calls; its backend named); the llm shape and
                   its head_dim 256 in f16 and f32 too, and the llm shape at
                   head_dim 384 and 512 (4 heads) in bf16 and f16.
18. llm_parity   — at full width, from the same weights and tokens, the
                   loss's gradients with attn_impl "auto" and with "ring"
                   agree leaf by leaf; then one LlmLoadGen step of each: the
                   losses and the updated weights agree, and the auto step
                   launches dQ and dK/dV once a layer and the forward twice.
19. llm_train    — LlmLoadGen at full width, auto and ring: step time,
                   tokens/s and the losses of some twenty steps.
20. llm_profile  — one auto step under torch.profiler: device time by
                   kernel, launches a step, the idle share.
20b. head256     — the serving container's sizes at D_MODEL=2048 N_HEADS=8
                   (head_dim 256): DecodeLoadGen's graph burst (a prefill of
                   512, 128 greedy tokens) against the same burst eagerly
                   with the prefill's attention on the plain version (the
                   logits within 0.06, the prompt's cache within 0.06 plus
                   2^-5 of its value), one forward launch a layer a prefill;
                   LlmLoadGen at that width auto against ring (the loss
                   within 0.05, each leaf's gradient within 5% of norm,
                   exact launches), then five auto steps: step ms, tokens/s,
                   the forward, dQ and dK/dV launches; reference_attention
                   counted (none).
20bb. head_wide  — the same at head_dim 512 and 384, the serving
                   container's sizes at D_MODEL=2048 and 1536 in N_HEADS=4,
                   on the chunked instantiations: in bf16 as head256 (three
                   auto steps), then in f16 one serve warm-up and graph
                   burst of 16 tokens (the prefill's logits against the
                   plain attention's within 0.06) and two auto steps, each
                   with exact launches; reference_attention counted (none).
20c. dtypes      — the three load generators in f16 and in f32 on the
                   kernels of those dtypes, every count set to 0 before each
                   and read after, and reference_attention counted (none):
                   MatmulLoadGen(size=4096, use_kernel=True), four bursts of
                   16 products, one GEMM a product, one product against the
                   plain version; DecodeLoadGen at the serve cell's sizes
                   (prefill 512, bursts of 16 tokens), its warm-up and one
                   graph replay, one forward a layer each, the prefill's
                   logits against the plain attention's (f16 0.06, f32
                   2e-3); LlmLoadGen at the rung's defaults auto against
                   ring (loss within 0.05 in f16 and 1e-3 in f32, each
                   leaf's gradient within 5% and 1e-3 of its norm), then
                   three auto steps: two forwards, one dQ and one dK/dV a
                   layer a step.
21. train_parity — the ResNet training rung at the shipped tpu-train width
                   (ResNet-50, CIFAR stem, image 32): one step on the card in
                   bf16 and channels_last against the same step on the CPU
                   in f32 from the same seeded weights and batch (16
                   images), the logits and the loss within 0.06 of their
                   RMS; a stage-3 BatchNorm's running statistics moved by
                   flax's update, the biased variance.
22. train_loadgen— TrainLoadGen at the shipped sizes (batch 256): step ms,
                   images/s and peak memory; the windowed duty cycle at
                   knob 0.25.
23. train_profile— one step under torch.profiler: kernels, device time by
                   kind (convolution, BatchNorm, elementwise, SGD, copies),
                   the idle share; the trace must hold every BatchNorm's
                   four kernels and the batch draw's two.
24. train_loop   — the training loop, as bench.py's training rung runs it:
                   TrainLoad → TorchDeviceSource (the windowed duty cycle, no
                   bandwidth gauge) → ExporterDaemon → Scraper → both
                   tpu-train rules → adapter → the shipped two-metric HPA
                   must scale 1 → 4 within the 60 s budget on the duty cycle
                   alone; which metrics it had at each sync.
25. train_entry  — ``python -m k8s_gpu_hpa_tpu_torch.loadgen.train`` with
                   CHECKPOINT_DIR, CHECKPOINT_EVERY 20 and PROFILE_S 1: it
                   writes its Chrome trace, saves on SIGTERM, exits 0, and
                   started again resumes from that save's step.
26. llm_entry    — ``python -m k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with
                   WORKLOAD=llm and CHECKPOINT_DIR trains and reports until
                   SIGTERM, saves, exits 0, and resumes from that step.
                   train_entry and llm_entry run at once, in two threads.
27. mesh         — a process group of this process alone over NCCL on the
                   card, its rendezvous on a free port of 127.0.0.1:
                   ``make_mesh()`` is {"data": 1, "model": 1} on cuda, and a
                   model axis of 2 is refused (ValueError).
28. tp_mlp       — the tensor-parallel MLP on that mesh (d_model 512,
                   d_hidden 2048, batch 256) against gelu_tanh(x @ w1) @ w2
                   computed plainly from the same weights: f32 within 2e-4,
                   bf16 within 0.06 of the output's RMS; its time.
29. allreduce_loadgen — ``AllReduceLoadGen()`` (64 MB, 4 rounds a burst, bf16)
                   on that mesh for 3 s: rounds, bytes a round, the rate
                   (at world 1 a device-local copy, not a link), the buffer
                   finite; one traced burst's kernels, NCCL's among them.
30. allreduce_entry — ``python -m k8s_gpu_hpa_tpu_torch.loadgen.multihost``
                   with no WORKLOAD (so allreduce) reports twice and exits 0
                   on SIGTERM: once with no topology, once with
                   COORDINATOR_ADDRESS=127.0.0.1:<free> NUM_PROCESSES=1, the
                   two processes at once.
31. train_dp     — at the shipped tpu-train sizes: over a group of one (NCCL)
                   ``TrainLoadGen(mesh=make_mesh())``'s three losses equal
                   ``TrainLoadGen()``'s bit for bit; two ranks share the card
                   over gloo, each a step on its half (128) of a global batch
                   whose halves differ in mean, against one rank's step on
                   the whole batch: the loss, the logits, every parameter's
                   update and every BatchNorm's batch statistics within 0.06
                   of their RMS; and what each half's own statistics would
                   have read.

32. ringattn_loadgen — ``RingAttentionLoadGen()`` at the rung's defaults
                   (1024 tokens, 8 heads of 128, bf16, 8 passes a burst) on
                   the mesh of one for 3 s: bursts, the context, TFLOP/s by
                   JAX's causal formula (a ring of one moves no block).
32b. moe_loadgen — ``MoELoadGen()`` at the container's defaults (d_model
                   512, d_ff 2048, 1024 tokens, 2 experts, 8 FFNs a burst,
                   bf16) on the mesh of one for 3 s, where the exchange moves
                   nothing: burst ms, tokens/s, the exchange's bytes (0); one
                   profiled burst's kernels and idle share; a burst against
                   the same chain through moe_ffn_reference within 0.06 of
                   its RMS.
33. tp_serve_graph — the TP burst at the shipped serve sizes on the (1, 1)
                   mesh over NCCL, captured as one CUDA graph, against the
                   single-device graph burst: tokens equal, the cache within
                   0.06 of its RMS; both burst times.
33b. slice_loop  — the slice pod's closed loop (run_slice_trial) while the
                   group of one is up: AllReduceLoadGen at its full width
                   (64 MB) as ordinal 0 of slice 0, a slice of one on NCCL
                   (a real second host would block at the rendezvous); its
                   slice peer and slices 1-3 are mirror pods of a
                   StatefulSet.  PacedLoad's windowed duty → TorchDeviceSource
                   → ExporterDaemon → Scraper → the slice rule on the duty
                   cycle → adapter on the StatefulSet → the shipped slice HPA
                   (target 40, pods 2..8, quantum 2, its behavior) at 0.2,
                   then 3.2 devices of load: all 8 pods run within 60 s of
                   the crossing, and no scale event lands off a slice
                   boundary.  It launches no hand-written kernel.
33c. slice_nvml  — NVML's duty cycle while the collective rung runs at knob
                   1.0 and 0.25, beside the generator's own busy share:
                   whether NVML reads the pod's copies and collectives as
                   busy.  Reported, not held to a bar.
33d. doctor_nvml — ``python -m k8s_gpu_hpa_tpu_torch.doctor nvml`` (the
                   NVML probe of doctor.py): every NVML call the node
                   exporter makes answers on the card (exit 0); GPM's
                   support and one sample's answer are reported.
34. ringattn_entry — the multihost command with WORKLOAD=ringattn reports
                   twice and exits 0 on SIGTERM.
34b. moe_entry   — the same with WORKLOAD=moe, one process: its banner shows
                   the generator's mesh {"data": 1, "model": 1}.  The two
                   commands run at once, each line with its ``wall_s``.
35. ring_parity  — two gloo ranks sharing the card run ``ring_attention`` at
                   the rung's default (b1, 2 × 1024, 8 heads of 128, causal)
                   against ``reference_attention`` over the whole sequence:
                   f32 within 2e-5, bf16 within 3e-2, and the f32 gradients
                   of q, k and v within 2e-4 of autograd through the
                   reference.
35b. ep_parity   — two gloo ranks sharing the card run the EP FFN at the
                   container's width with a model axis of 2 (4 experts, 1024
                   tokens) against moe_ffn_reference on one device: f32
                   within 2e-5, bf16 within 0.06 of its RMS, and the f32
                   gradients of the router and both expert weights within
                   2e-4 (each rank's loss scaled by 1/2, each gradient summed
                   over the ranks that hold the parameter).
35c. pp_parity   — two gloo ranks run the pipeline at PipelineConfig()'s
                   width in f32 (8 layers, 4 a stage, 4 microbatches of 16)
                   against pp_forward_reference on one device in f64: the
                   output within 2e-5 on both stages, the gradients within
                   2e-4; the same reference in f32 on one device is read
                   beside them.
36. tp_serve_parity — ``DecodeLoadGen(model_parallelism=2)`` at the shipped
                   serve sizes on two gloo ranks against the single-device
                   generator, same weights and prompt: the prefill's logits,
                   the logits of 8 greedy steps fed the one device's tokens
                   and the cache they filled within 0.06 of their RMS; the
                   greedy tokens equal except at near-ties (the one device's
                   top two logits within that bar of the logits' RMS; at
                   least 3 in 4 steps no near-tie); each rank's flash
                   forward 4 launches a burst, the burst eager on gloo; the
                   one device with a rank's attention split (its flash
                   forward on each half of the heads) read beside both.
37. llm_sp       — sequence-parallel training at the llm rung's defaults on
                   two gloo ranks (2 × 2048 tokens) against one rank on the
                   whole 4096 (attn_impl ring): the loss within 0.05, the
                   logits and each leaf's f32 update within 0.06 of their
                   RMS, both ranks' parameters identical after a step and
                   each within a bf16 step of the one rank's; then
                   WORKLOAD=llm as two processes of one slice
                   (DIST_BACKEND=gloo) reports, saves on SIGTERM, exits 0
                   and resumes from that save.
38. hbm_pods_loop — the HBM Pods loop (run_hbm_pods_trial), bench.py's HBM
                   rung at time scale 1: HbmHold holds real device memory
                   in 1/4 GiB blocks as pod tpu-test-v5e8-real, each running
                   pod's one device reports the held bytes → ExporterDaemon
                   → Scraper → the pod-max rule → the adapter's Pods API →
                   the shipped HBM HPA (Pods, AverageValue 13Gi, pods 1..4):
                   0.5 GiB, then from 3 s min(44 GiB / running, 14.5 GiB) a
                   pod; all 4 replicas run within 60 s of the crossing.  At
                   the peak the held bytes beside the growth of the
                   allocator's bytes, its reservation and NVML's memory in
                   use; the allocator's growth must be at least the held
                   bytes.  Every sync's reading and reason.  It launches no
                   hand-written kernel.
39. queue_external — the serving container (``python -m
                   k8s_gpu_hpa_tpu_torch.loadgen``, WORKLOAD=decode,
                   PREFILL_LEN=512, N_HEADS=4, QUEUE_NAME=tpu-serve) as a
                   subprocess, attributed through a kubelet response; an
                   ExporterDaemon on NVML merges its self-report, and the
                   queue's path (trial.QueueJoint) serves
                   tpu_test_queue_depth{queue="tpu-serve"} on
                   external.metrics.k8s.io: the served depth equals the
                   depth the telemetry file held at that sweep, the depth
                   grows at knob 1.0 (4x one worker's capacity offered), one
                   sync of the queue HPA (external_hpa_doc()) from 1
                   replica proposes ceil(sum / 100) within the policy's 3,
                   the queue drains below one request at knob 0, and the
                   container exits 0 on SIGTERM.  Its prefill runs the flash
                   forward: the container reports its launches.
40. simulate     — the scenario simulator on the card's machine, importing
                   neither JAX nor a YAML library: default_bundle() rendered with
                   to_yaml and read back with load_yaml_all, equal document
                   for document, and every shipped deploy/*-hpa.yaml read
                   and parsed; simulate.run_scenario("spike") on the
                   headline HPA with saturated_pct the loadgen phase's
                   dwell MFU, and on the serve HPA with the serve phase's
                   saturated signal: both verdicts "target reachable", as
                   the live loops' 1 → 4 showed, each simulated
                   scale_up_latency printed beside that loop's scale_up_s;
                   the slice HPA's spike, every scale event on a multiple
                   of 2 and 8 pods reached; run_cpu_resource_trial(), the
                   Resource HPA's rung, 4 replicas.  The kernels' counts are
                   set to 0 before it and read after: it launches none.
                   Whether PyYAML is installed there is reported; the
                   port never imports it.
41. trace        — the tracing plane, in this process: the signal-latency
                   rung (trial.signal_latency_run, the traced pipeline of
                   bench.py's run_rung_signal_latency) must give the JAX
                   package's dict: 3 of 3 load steps scaled, sync and scale
                   latency p50 = p95 = 15.0 s within the 60 s budget, 2162
                   spans, 5 replicas, and no SLO burn-rate alert may fire at
                   any second of that clean run; its self-metrics, read from
                   its TSDB as an instant-query payload, must pass
                   doctor.check_self_metrics.  Then the traced spike on
                   deploy/tpu-test-hpa.yaml (read with load_yaml) must give
                   the JAX package's span counts, every scale event's
                   lineage must reach the exporter sweeps, and the trace
                   must come back from a JSONL file unchanged.  The spans by
                   kind, the propagation report and each scale event's hops
                   are printed.  The kernels' counts are set to 0 before it
                   and read after: it launches none.
42. chaos        — the chaos plane and the shipped alerts, in this process on
                   virtual clocks: the canned fault storm
                   (chaos.run_fault_storm, bench.py's chaos_storm rung through
                   trial.chaos_storm_rung) must give the JAX package's
                   numbers exactly: 3 replicas settled, every fault recovered,
                   no scale event and the FailedGetObjectMetric condition
                   during the blackout, MTTR 8, 15, 11 and 37 s, every
                   detection at 0 s, 8979 spans and fault_window spans 1954,
                   2790, 4967 and 6851; the SLO check (trial.slo_burn_rung,
                   bench.py's slo_burn rung) no false positive on the clean
                   run, the fast scrape-success alert first firing at 140 s
                   and the slow one at 127 s (20 and 7 s after the
                   blackout).  The storm runs again with the shipped alerts
                   (metrics.rules.shipped_alert_rules) evaluated on its TSDB
                   each second: as in the JAX package only
                   TpuAutoscaleSignalAbsent fires, from 375 s (inside the
                   315-405 s blackout) until 415 s; doctor.check_alerts,
                   given the alerts as Prometheus's /api/v1/alerts lists
                   them, must raise on that alert at its first firing and
                   pass on the storm's end.  gen-manifests' PrometheusRule,
                   written and read back with load_yaml_all, must hold the
                   tpu-pipeline-alerts and tpu-slo-burn groups as the
                   generator renders them.
                   The kernels' counts are set to 0 before it and read after:
                   it launches none.
43. drill        — durability, in this process on virtual clocks and a
                   temporary directory of this host: the recovery drill
                   (control.scale_harness.run_recovery_drill, bench.py's
                   recovery_drill rung through trial.drill_rung)
                   must give the JAX package's numbers exactly: 3 replicas
                   settled; a TSDB restart from the WAL at 30 s, an HPA
                   restart from its checkpoint file at 210 s, an adapter
                   restart at 390 s and a WAL truncated and recovered at
                   570 s, each with MTTR 0 and its first good sync at 0 s;
                   a replay gap of 1.0 s; no scale event in a recovery
                   window; 2 scale events with complete lineages; 4/4 at the
                   end; 8724 spans.  Its two TSDB restarts must recover
                   the JAX package's 137 series, 18300 points, 1916
                   replayed records and 127, 45486, 2560.  Then a
                   durable pipeline under the drill's load for 10 s has its
                   WAL's last segment cut at every byte: each cut must
                   recover to the snapshot fed exactly the records that
                   landed.  And an HPA rebuilt mid-window from its
                   checkpoint file must recommend 4, 4, 4, 4, 4, 4, 1, 1 as
                   an uninterrupted one does, a cold one must scale down at
                   its first sync, and a torn file must load as None.  The
                   kernels' counts are set to 0 before it and read after:
                   it launches none.
44. metrics_scale — the metrics plane at scale, in this process on virtual
                   clocks: bench.py's sim_scale (200 targets over 600 s),
                   sim_scale_10k (2000 over 600 s on 4 hash-ring shards)
                   and query_bench (500 series on 4 shard DBs over 1800 s)
                   rungs at their smoke sizes (trial.sim_scale_rung,
                   sim_scale_10k_rung and query_bench_rung) on Gorilla
                   chunks, the query planner and the federated TSDB.  Every
                   field that does not read the wall clock must be the JAX
                   package's (METRICS_SCALE_EXPECTED: retained points and
                   bytes, compression, appends, series, the fleet vector,
                   the rule's full and skipped evaluations, replicas, scale
                   events, the ring's invariants, identical vectors, the
                   planner's and the decode cache's counts), and each
                   rung's speedup must clear its perfgates floor.  The
                   query p95 and the appends rate are printed beside their
                   bars (meets_p95_budget, meets_appends_floor) and do not
                   fail it.  The kernels' counts are set to 0 before it and
                   read after: it launches none.
45. rollups      — the metrics plane's rollup tiers and the flight recorder,
                   in this process on virtual clocks: bench.py's
                   downsample_bench rung at its smoke size
                   (trial.downsample_bench_rung: 200 series on 2
                   downsampling shard DBs, 6 h at 30 s, a 3 h window at hour
                   4 from the 1h rollups and from raw), then simulate's
                   history at 0.125 virtual days and why on its first scale
                   event.  Every deterministic field must be the JAX
                   package's (ROLLUPS_EXPECTED: the bench's points, series,
                   rollup reads, bytes, ratio, tiers and differential; the
                   history's scale events with their lineages, fault
                   windows, restarts, hourly table, tier buckets and rule
                   reads by tier, with no violation; the why's hop kinds,
                   its lineage complete, and an unknown id refused).  The
                   bench's speedup must clear its smoke floor of 3.0 and its
                   bytes ratio stay within 0.1; the history's tier bytes,
                   which roll up the pipeline's wall-clock self-metrics,
                   are printed beside the range the JAX package's runs gave
                   and do not fail it.  The kernels' counts are set to 0
                   before it and read after: it launches none.
46. capacity     — the capacity economy and the slice-quantum operator, in
                   this process on virtual clocks and 127.0.0.1: the crunch
                   (chaos.run_capacity_crunch, bench.py's capacity_crunch
                   rung: three tenants spike into a pool of two 8-device
                   nodes while provisioning fails and a node drains) must be
                   the JAX package's field for field (CRUNCH_EXPECTED: each
                   tenant's time to capacity, worst wait, evictions and end
                   state; 2 provisions, 1 failure, both autoscaled nodes
                   reaped; 224 audits, all conserved; the scheduler's events
                   by kind; no violation) and as a whole (CRUNCH_SHA256 of
                   its sorted JSON); capacity_selfcheck() must be JAX's and
                   pass the doctor's check_capacity_pool with JAX's verdict;
                   and a QuantumOperator with its Lease and health server
                   against a fake API server (FakeKubeAPI) must round a
                   growing partial slice up (5 → 8), hold a steady one (6)
                   until its HPA grows, answer /healthz and /readyz, and
                   serve /metrics that check_operator_metrics refuses while
                   the slice is held and passes after (OPERATOR_EXPECTED).
                   The crunch runs under a coverage map and a profile map
                   together, which the coverage phase holds.  The kernels'
                   counts are set to 0 before it and read after: it
                   launches none.
47. evacuate     — the region evacuation, in this process on a virtual
                   clock: three regional stacks under one global control
                   plane, the home region killed through an object-store
                   outage and a survivor's partition (bench.py's
                   region_evacuation rung: the full run and the smoke canary
                   with spilling off).  Each run's wall seconds,
                   evacuation_fingerprint and SHA-256 of its sorted JSON
                   without ``objstore.bytes`` must be the JAX package's
                   (EVAC_EXPECTED; the canary breaks the contract with 5
                   violations), and the rung's ``ok`` must hold.  The
                   store's byte count is printed beside the range JAX's runs
                   gave (EVAC_JAX_BYTES).  The kernels' counts are set to 0
                   before it and read after: it launches none.
48. coverage     — the simulator's self-observability, in this process on
                   virtual clocks: the capacity phase's crunch maps, then
                   simulate.run_coverage("profile") and
                   profile_harness.run_profile("scale", smoke=True).  The
                   crunch's coverage export and profile canonical export,
                   the profile run's coverage export and the smoke scale
                   run's canonical export must hash (SHA-256) to the JAX
                   package's (COVERAGE_EXPECTED), with no open span and the
                   scale run's attribution at least
                   perfgates.PROFILE_MIN_ATTRIBUTION; each export's hit
                   count and wall seconds, and the attributions, are
                   printed.  The kernels' counts are set to 0 before it and
                   read after: it launches none.
49. incident     — the adversarial and paging planes, in this process on
                   virtual clocks: simulate.run_coverage("incident") (a
                   smoke evacuation paging drill and the alert router's and
                   incident correlator's edges), the mis-inhibition canary
                   (paging.run_paging_evacuation(smoke=True,
                   break_inhibition=True)) and fuzz.replay_artifact of each
                   committed fuzz artifact (tests/scenarios/
                   break-grace-canary.json and overlap-stress.json).  The
                   session's export and the canary's result must hash
                   (SHA-256 of their canonical JSON) to the JAX package's
                   (INCIDENT_EXPECTED), the canary must fail the paging
                   contract on an uninhibited duplicate page, and each
                   replay must reproduce its fingerprint and violations;
                   each run's digest, hit or page count and wall seconds are
                   printed.  The kernels' counts are set to 0 before it and
                   read after: it launches none.
50. races        — the race harness and the static-analysis gate, in this
                   process on the host: race_harness.run_race_sweep() (a
                   serial reference, four seeded permutations of the
                   shard-rules fan-out and one run on a real
                   ThreadPoolExecutor, the coverage map's inferred lockset
                   armed as runtime assertions), its break-ordering canary
                   at seed 7, simulate.run_coverage("races") and
                   analysis.run_passes() over this checkout.  The sweep, the
                   canary and the export must hash to the JAX package's
                   (RACES_EXPECTED), the sweep pass, the canary diverge and
                   the gate's ten passes be clean; each run's digest and
                   wall seconds, and the gate's, are printed.  The kernels'
                   counts are set to 0 before it and read after: it
                   launches none.

Phases 41-50 (``phase_host_only``) run in a process of their own, started
before the headline loop (phase 7) and run beside it: they launch no
kernel, and the loop leaves the host's cores idle while it waits on its
syncs.  Their lines are printed after phase 40, each ``t_s`` on the
script's clock; that process must exit 0 with no process of its own left.

No hand-written kernel is on the ResNet path: its convolutions are cuDNN's,
its BatchNorm PyTorch's own kernels and its head cuBLAS's, as XLA's are in
the JAX package.  Nor on the mesh's paths (phases 27-35c, 37): their
collectives are NCCL's or gloo's, their products cuBLAS's and the ring, the
experts' routing and exchange and the pipeline's stages plain PyTorch, as
the JAX package leaves them to XLA.  TP serving's prefill (phases
33 and 36) runs the flash forward on each rank's local heads.  The card has
one GPU and NCCL takes one rank a GPU, so nothing there runs on NCCL across
ranks: two ranks share it over gloo, whose times are not rates.

Launch counts.  Each wrapper counts the launches it makes.  The GEMM's
launches on the main path are those of loop, overshoot and node_loop, each
counted from zero.  A decode burst
is one replay of a CUDA graph, and the graph's launches happen without the
wrapper: the flash wrapper counts them once, when the burst is captured
(``DecodeLoadGen.flash_launches_per_burst``).  So the serve loop's flash
launches are the wrapper's count in that run plus the replays in that run
times the launches one replay makes.

The training path's launches are those of llm_parity's auto step plus
llm_train's auto steps, each counted from zero; the flash forward's are
those of the serve loop plus the training path's plus TP serving's: the
graph bursts of tp_serve_graph (its replays times the captured burst's
launches) and the generator bursts of tp_serve_parity's two ranks (eager on
gloo, counted by each rank's wrapper from zero), and the serving
container's in queue_external, which it counts the same way in its own
process and reports when it stops.

Each phase's line carries ``t_s``, its end in seconds since the script
began.  Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
...}`` line.
Nothing falls back to the CPU: without a GPU the script exits 1 and prints
no result.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import hashlib
import importlib.util
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

from k8s_gpu_hpa_tpu_torch.device import peak_hbm_gbps_for, peak_tflops_for
from k8s_gpu_hpa_tpu_torch.exporter import native, nvml
from k8s_gpu_hpa_tpu_torch.exporter.podresources import (
    GPU_RESOURCE,
    StaticAttributor,
    parse_list_response,
)
from k8s_gpu_hpa_tpu_torch.exporter.sources import NvmlSource
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    HBM_MAX_REPLICAS,
    HBM_SERIES,
    MULTIHOST_MAX_REPLICAS,
    MULTIHOST_QUANTUM,
    QUANTUM_ANNOTATION,
    QUEUE_SELECTOR,
    QUEUE_SERIES,
    TRAIN_BW_SERIES,
    TRAIN_DUTY_SERIES,
)
from k8s_gpu_hpa_tpu_torch.loadgen.allreduce import AllReduceLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.decode import SERVE_SIZES, DecodeLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.knob import IntensityKnob
from k8s_gpu_hpa_tpu_torch.loadgen.llm import LlmLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.matmul import MatmulLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.moe import MoELoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.multihost import (
    HostTopology, free_port, initialize, launch, stop_rank_server,
)
from k8s_gpu_hpa_tpu_torch.loadgen.ringattn import RingAttentionLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.train import TrainLoadGen, make_checkpoint_manager
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.metrics.rules import SERVE_BW_TARGET, RuleEvaluator, shipped_alert_rules
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_CHIP_POWER,
    TPU_CHIP_TEMP,
    TPU_DUTY_CYCLE,
    TPU_TENSORCORE_UTIL,
)
from k8s_gpu_hpa_tpu_torch.models import moe, pipeline, transformer
from k8s_gpu_hpa_tpu_torch.models.resnet import BatchNorm
from k8s_gpu_hpa_tpu_torch.models.tp_mlp import init_tp_mlp, tp_mlp_forward
from k8s_gpu_hpa_tpu_torch.ops import flash_attention, matmul
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_bwd_delta,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq_reference,
    flash_attention_bwd_kernel,
    flash_attention_bwd_launch,
    flash_attention_bwd_reference,
    flash_attention_kernel,
    flash_attention_reference,
)
from k8s_gpu_hpa_tpu_torch.ops.matmul import matmul_kernel, matmul_reference
from k8s_gpu_hpa_tpu_torch.ops.ring_attention import reference_attention, ring_attention
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh, mesh_shape
from k8s_gpu_hpa_tpu_torch.utils import dwell
from k8s_gpu_hpa_tpu_torch import analysis, perfgates, simulate, trial
from k8s_gpu_hpa_tpu_torch.__main__ import main as cli_main
from k8s_gpu_hpa_tpu_torch.chaos import run_capacity_crunch, run_fault_storm, run_region_evacuation
from k8s_gpu_hpa_tpu_torch.chaos.evacuate import evacuation_fingerprint
from k8s_gpu_hpa_tpu_torch.chaos.fuzz import replay_artifact
from k8s_gpu_hpa_tpu_torch.chaos.paging import run_paging_evacuation
from k8s_gpu_hpa_tpu_torch.control.capacity import capacity_selfcheck
from k8s_gpu_hpa_tpu_torch.control.profile_harness import run_profile
from k8s_gpu_hpa_tpu_torch.control.race_harness import run_race_sweep
from k8s_gpu_hpa_tpu_torch.control.operator import (
    KubeClient,
    LeaseElector,
    QuantumOperator,
    start_health_server,
)
from k8s_gpu_hpa_tpu_torch.doctor import (
    check_alerts,
    check_capacity_pool,
    check_operator_metrics,
    check_self_metrics,
)
from k8s_gpu_hpa_tpu_torch.obs import (
    SELF_METRIC_NAMES,
    coverage,
    index_spans,
    lineage_of,
    profile,
    propagation_report,
    read_jsonl,
)
from k8s_gpu_hpa_tpu_torch.control.adapter import ObjectReference
from k8s_gpu_hpa_tpu_torch.control.checkpoint import FileCheckpointStore
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.external_sim import ScaleTarget
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    HPABehavior,
    HPAController,
    ObjectMetricSpec,
    ScalingRules,
    metrics_from_manifest,
)
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.control.scale_harness import run_recovery_drill
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.metrics.wal import WriteAheadLog
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from k8s_gpu_hpa_tpu_torch.manifests import (
    default_bundle,
    load_yaml,
    load_yaml_all,
    prometheusrule_manifest,
    to_yaml,
)
from k8s_gpu_hpa_tpu_torch.trial import (
    GIB,
    DUTY_SERIES,
    PROBE_NEED,
    REAL_POD,
    SERVE_SERIES,
    TENSORCORE_SERIES,
    TARGET,
    HbmHold,
    LoadThread,
    QueueJoint,
    WindowedDuty,
    measure_saturated_signal,
    run_headline_overshoot_probe,
    run_headline_trial,
    run_hbm_pods_trial,
    run_cpu_resource_trial,
    run_node_headline_trial,
    run_serve_trial,
    run_slice_trial,
    run_train_trial,
)
from k8s_gpu_hpa_tpu_torch.utils import protowire

#: the kernels' dtypes by name; the two each kernel takes beside bf16: f16 (the
#: wgmma sources built as f16) and f32 (the FFMA sources)
DT_NAME = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
NEW_DTYPES = (torch.float16, torch.float32)
#: explicit mantissa bits, for an error in units of the dtype's ulp
MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}
# M, K, N, dtype: the loadgen's shape; the JAX parity test's (N 128, half of
# the kernel's 256-wide tile); a shape the JAX package would run on its
# k-grid kernel; a shallow wide one (K 128, two K steps); one tile with K and
# N 128; and N 384 (a tile column half outside C) over five tile rows; each
# in bf16, f16 and f32
PARITY_SHAPES = [
    (*mkn, dt) for dt in DT_NAME for mkn in (
        (4096, 4096, 4096), (256, 384, 128), (1024, 8192, 2048), (512, 128, 1024),
        (128, 128, 128), (640, 2048, 384))
]
# bf16 output: each side rounds its fp32 sum to bf16 once, so two results can
# differ by one bf16 ulp (2^-7 relative at worst) and by the fp32 sums'
# different summation order; rtol 2^-6 allows two ulps, atol the order.
# Readings (NVIDIA H100 80GB HBM3, this phase): at every shape the worst
# error is one bf16 ulp of the reference's value there (2.0 at -278 for
# 1024x8192x2048), and no element is outside the bar.
RTOL = 2.0**-6
ATOL = 1e-2
SIZE = 4096
#: (atol, rtol) of the GEMM by dtype: f16 at bf16's bar (f16 rounds finer);
#: f32 at the JAX package's f32 bar, rtol and atol 1e-3
#: (tests/test_jax_workloads.py:35-42), against the plain version with TF32 off
GEMM_BARS = {torch.bfloat16: (ATOL, RTOL), torch.float16: (ATOL, RTOL),
             torch.float32: (1e-3, 1e-3)}

#: the chunked instantiations' head_dims (bf16 and f16 only)
WIDE_HEAD_DIMS = (384, 512)
#: the streamed instantiations' head_dims held here, by dtype: any multiple
#: of 128 from 640 on in bf16 and f16 (five and eight 128-column chunks),
#: from 384 on in f32 (``flash_attention.STREAMED_FROM``)
STREAMED_HEAD_DIMS = {torch.bfloat16: (640, 1024), torch.float16: (640, 1024),
                      torch.float32: (384, 512, 1024)}


def _kind(d: int, dt: torch.dtype) -> str:
    """The key of a row's worst error: its dtype's name, and ``_wide`` on the
    chunked instantiations or ``_streamed`` on the streamed ones."""
    if flash_attention.streamed(d, dt):
        return DT_NAME[dt] + "_streamed"
    return DT_NAME[dt] + ("_wide" if d in WIDE_HEAD_DIMS else "")


def _bwd_kind(d: int, dt: torch.dtype) -> str:
    """``_kind`` of a backward row, and ``f32_cluster`` on the f32
    backward's cluster tiling (``flash_attention.CLUSTER_HEAD_DIMS``)."""
    if dt == torch.float32 and d in flash_attention.CLUSTER_HEAD_DIMS:
        return "f32_cluster"
    return _kind(d, dt)


# (batch, seq, heads, head_dim, causal, with_lse, consumer warpgroups a CTA
# or None for the wrapper's choice, dtype): in bf16 the serve prefill's
# shape causal and not, with the logsumexp; the llm training shape with the
# logsumexp; one KV tile; seq 192 causal and not on each split (on two
# warpgroups the first Q tile leaves the second none); head_dim 64 on each
# over ten K/V tiles, more than twice either ring's stages; the long timed
# shape; then head_dim 256 (HEAD256_SIZES): its prefill causal with and
# without the logsumexp, its training shape with it, seq 192 causal and not
# on its one split, and ten K/V tiles, more than three times its ring's
# three stages.  Then f16 (the wgmma kernel built as f16: each split at
# head_dim 64 and 128) and f32 (the FFMA kernel, one tiling): the prefill
# causal without and not with the logsumexp, the training shape, head_dim 64
# over ten tiles and seq 192 not causal, and head_dim 256 at seq 192 both
# ways and at its training and prefill shapes
FLASH_SHAPES = [
    *((*row, torch.bfloat16) for row in [
        (8, 512, 4, 128, True, False, None),
        (8, 512, 4, 128, False, False, None),
        (8, 512, 4, 128, True, True, None),
        (1, 2048, 4, 128, True, True, None),
        (2, 64, 4, 128, True, True, None),
        *((2, 192, 3, 128, causal, True, split) for causal in (True, False)
          for split in flash_attention.FWD_SPLITS),
        *((2, 640, 2, 64, True, True, split) for split in flash_attention.FWD_SPLITS),
        (2, 4096, 8, 128, True, True, None),
        (8, 512, 8, 256, True, False, None),
        (8, 512, 8, 256, True, True, None),
        (1, 2048, 8, 256, True, True, None),
        *((2, 192, 3, 256, causal, True, split) for causal in (True, False)
          for split in flash_attention.fwd_splits(256)),
        (2, 640, 2, 256, True, True, None),
    ]),
    *((*row, dt) for dt in NEW_DTYPES for row in [
        (8, 512, 4, 128, True, False, None), (8, 512, 4, 128, False, True, None),
        (1, 2048, 4, 128, True, True, None),
        *((2, 640, 2, 64, True, True, split) for split in flash_attention.fwd_splits(64, dt)),
        (2, 192, 3, 64, False, False, None),
        *((2, 192, 3, 128, True, True, split) for split in flash_attention.fwd_splits(128, dt)),
        (2, 192, 3, 256, True, True, None), (2, 192, 3, 256, False, False, None),
        (1, 2048, 8, 256, True, True, None), (8, 512, 8, 256, True, False, None),
    ]),
    # head_dim 384 and 512 (WIDE_SIZES), the chunked tilings, in bf16 and
    # f16: the prefill (bf16), the training shape with the logsumexp, seq
    # 192 causal and not, and 20 K/V tiles of 32 rows (seq 640), more than
    # five times either ring's stages
    *((*row, dt) for dt in (torch.bfloat16, torch.float16) for d in WIDE_HEAD_DIMS for row in [
        *([(8, 512, 4, d, True, False, None)] if dt == torch.bfloat16 else []),
        (1, 2048, 4, d, True, True, None), (2, 192, 3, d, True, True, None),
        (2, 192, 3, d, False, True, None), (2, 640, 2, d, True, True, None),
    ]),
    # the streamed instantiations (STREAMED_HEAD_DIMS): in bf16 and f16 at
    # head_dim 640 and 1024 seq 192 causal and not, and ten K/V tiles (seq
    # 640), which wrap the two-stage V ring five times; the training shape of
    # D_MODEL=2048 N_HEADS=2 (b1 s2048 h2 d1024) with the logsumexp, and in
    # bf16 its prefill; in f32 at 384, 512 and 1024 seq 192 causal and not,
    # and the training shape of four heads of 384 and 512
    *((*row, dt) for dt in (torch.bfloat16, torch.float16) for row in [
        *((2, 192, 3, d, causal, True, None) for d in STREAMED_HEAD_DIMS[dt]
          for causal in (True, False)),
        *((1, 640, 2, d, True, True, None) for d in STREAMED_HEAD_DIMS[dt]),
        (1, 2048, 2, 1024, True, True, None),
        *([(8, 512, 2, 1024, True, False, None)] if dt == torch.bfloat16 else []),
    ]),
    *((*row, torch.float32) for row in [
        *((2, 192, 3, d, causal, True, None) for d in STREAMED_HEAD_DIMS[torch.float32]
          for causal in (True, False)),
        (1, 2048, 4, 384, True, True, None), (1, 2048, 4, 512, True, True, None),
    ]),
]
# bf16 output, each side rounding P to bf16 once per KV tile it sums: the
# kernel per 64-key tile against its running max, the plain version once
# against the row's max, so a term can differ by one bf16 ulp of P; then the
# output rounds once on each side.  0.02 absolute allows about two ulps at
# the outputs' magnitude (|o| < 2 for these inputs) and is under the JAX
# package's bf16 bar of 0.06.  The logsumexp is fp32 on both sides: 1e-4.
# Where |o| is small, as at the long shape (RMS 0.07), 0.02 is loose: the
# error's RMS over the output's RMS is held to FLASH_REL_RMS as well.  Its
# readings (NVIDIA H100 80GB HBM3, this phase) were 3e-5 to 2.3e-3, the
# worst at seq 192 not causal; the bar is about twice that.  A 64-key tile
# dropped or read stale moves it far past the bar.
FLASH_ATOL = 0.02
LSE_ATOL = 1e-4
FLASH_REL_RMS = 5e-3
#: the forward's (atol, rtol) by dtype: f16 at bf16's (f16 rounds P and O
#: finer); f32 at the JAX package's f32 bar, 2e-3 both
#: (tests/test_flash_attention.py:31), against the plain version with TF32 off
FLASH_BARS = {torch.bfloat16: (FLASH_ATOL, 0.0), torch.float16: (FLASH_ATOL, 0.0),
              torch.float32: (2e-3, 2e-3)}
# (batch, seq, heads, head_dim, with_lse, on fused-QKV views, dtype),
# causal, for timing: the prefill's shape; the llm training shape as the
# transformer's training step calls it; a long one; and head_dim 256's
# prefill and training shape, the latter as the training step calls it; in
# bf16, then the four but the long one in f16 and in f32
FLASH_TIMED = [
    *((*row, dt) for dt in DT_NAME for row in (
        (8, 512, 4, 128, False, False), (1, 2048, 4, 128, True, True),
        (2, 4096, 8, 128, False, False), (8, 512, 8, 256, False, False),
        (1, 2048, 8, 256, True, True)) if dt == torch.bfloat16 or row[0] != 2),
    # head_dim 384 and 512: the prefill (b8 s512 h4) and the training shape
    # (b1 s2048 h4) in bf16, the training shape in f16
    *((*row, dt) for dt in (torch.bfloat16, torch.float16) for d in WIDE_HEAD_DIMS for row in (
        (8, 512, 4, d, False, False), (1, 2048, 4, d, True, True))
      if dt == torch.bfloat16 or row[0] == 1),
    # the streamed instantiations: head_dim 1024's prefill (b8 s512 h2) and
    # training shape (b1 s2048 h2) in bf16, the training shape in f16, and
    # in f32 the training shape of four heads of 512
    (8, 512, 2, 1024, False, False, torch.bfloat16), (1, 2048, 2, 1024, True, True, torch.bfloat16),
    (1, 2048, 2, 1024, True, True, torch.float16), (1, 2048, 4, 512, True, True, torch.float32),
]
# serve parity at the shipped sizes in bf16: prefill against stepwise decode
# reach the cache and the logits through other products (a [b, 512, d] GEMM
# and the flash kernel against [b, 1, d] GEMMs and the decode's products), so
# bf16 roundings land elsewhere and carry through four layers; the JAX
# package's bf16 attention bar, 0.06, holds the logits, and the cache is held
# to 0.06 plus four bf16 ulps of its value
SERVE_ATOL = 0.06
SERVE_CACHE_RTOL = 2.0**-5

#: the llm training rung's attention (LlmLoadGen's defaults: batch 1, 2048
#: tokens, 4 heads of 128)
LLM_SHAPE = (1, 2048, 4, 128)
#: head_dim 256: the shipped serving container's sizes (SERVE_SIZES: batch 8,
#: context 2048, prefill 512, 4 layers) at D_MODEL=2048 N_HEADS=8, the head
#: width of Gemma's 2B and 7B models, and the llm rung at that width (batch
#: 1, 2048 tokens); d_ff is 4 d_model in both
HEAD256_SIZES = {**SERVE_SIZES, "d_model": 2048, "n_heads": 8}
#: the auto steps the head256 phase times: a count, not a time
HEAD256_STEPS = 2
#: the llm rung's attention at that width: 8 heads of 256
LLM_SHAPE_D256 = (1, 2048, 8, 256)
#: head_dim 512 and 384: the serving container's sizes at D_MODEL=2048
#: N_HEADS=4 and at D_MODEL=1536 N_HEADS=4, on the chunked instantiations,
#: and the llm rung at those widths (4 heads of 512 and of 384)
WIDE_SIZES = {512: {**SERVE_SIZES, "d_model": 2048, "n_heads": 4},
              384: {**SERVE_SIZES, "d_model": 1536, "n_heads": 4}}
#: the auto steps the wide phase times at each width, in bf16 and in f16
WIDE_STEPS, WIDE_F16_STEPS = 1, 1
#: head_dim 1024: the serving container's sizes at D_MODEL=2048 N_HEADS=2
#: (deploy/tpu-serve-deployment.yaml's knobs), on the streamed
#: instantiations, and the llm rung at that width; then head_dim 512 in
#: f32, the serving container and the llm rung at D_MODEL=2048 N_HEADS=4
STREAMED_SIZES = {**SERVE_SIZES, "d_model": 2048, "n_heads": 2}
#: the head1024 phase's depth: tokens a serve burst (after its prefill of
#: 512) and auto steps, in each dtype
STREAMED_TOKENS, STREAMED_STEPS = 16, 1
# (batch, seq, heads, head_dim, causal, dtype): the llm shape causal and
# not; seq 192, whose backward runs three 64-row tiles a side, the dK/dV
# loop starting at the diagonal; head_dim 64 over ten tiles a side, which
# wraps every ring; and at head_dim 256 the llm shape causal and not (32
# tiles a side wrap its two-stage rings) and seq 192; in bf16, and but the
# d256 llm shape not causal in f16 and f32 (seq 192 not causal at d128
# there instead)
BWD_SHAPES = [
    *((*row, torch.bfloat16) for row in (
        (*LLM_SHAPE, True), (*LLM_SHAPE, False), (2, 192, 3, 128, True), (2, 640, 2, 64, True),
        (*LLM_SHAPE_D256, True), (*LLM_SHAPE_D256, False), (2, 192, 3, 256, True))),
    *((*row, dt) for dt in NEW_DTYPES for row in (
        (*LLM_SHAPE, True), (*LLM_SHAPE, False), (2, 192, 3, 128, False), (2, 640, 2, 64, True),
        (*LLM_SHAPE_D256, True), (2, 192, 3, 256, True), (2, 192, 3, 256, False))),
    # head_dim 384 and 512 in bf16 and f16: the llm shape at those widths
    # (4 heads) causal and not, seq 192 causal and not (the dK/dV loop from
    # the diagonal), and 20 streamed tiles of 32 rows (seq 640), which wrap
    # the two- and one-stage rings
    *((*row, dt) for dt in (torch.bfloat16, torch.float16) for d in WIDE_HEAD_DIMS for row in (
        (1, 2048, 4, d, True), (1, 2048, 4, d, False), (2, 192, 3, d, True),
        (2, 192, 3, d, False), (1, 640, 1, d, True))),
    # the serve prefill's shape at head_dim 512 and 384 (b8 s512 h4), causal,
    # in bf16, refereed against the exact gradient (BWD_F64_SHAPES)
    *((8, 512, 4, d, True, torch.bfloat16) for d in WIDE_HEAD_DIMS),
    # the streamed instantiations: in bf16 and f16 at head_dim 640 and 1024
    # seq 192 causal and not (the dK/dV loop from the diagonal) and ten
    # 64-row tiles a side (seq 640), which wrap the two-stage rings five
    # times, and the training shape of D_MODEL=2048 N_HEADS=2; in f32 on
    # the cluster tiling at 384, 512 and 1024 (clusters of 3, 4 and 8) seq
    # 192 causal and not, and the training shape of four heads of 384 and
    # 512, and past it on the streamed tiling at 1152 seq 192 causal
    *((*row, dt) for dt in (torch.bfloat16, torch.float16) for row in (
        *((2, 192, 3, d, causal) for d in STREAMED_HEAD_DIMS[dt] for causal in (True, False)),
        *((1, 640, 1, d, True) for d in STREAMED_HEAD_DIMS[dt]), (1, 2048, 2, 1024, True))),
    *((*row, torch.float32) for row in (
        *((2, 192, 3, d, causal) for d in STREAMED_HEAD_DIMS[torch.float32]
          for causal in (True, False)),
        (1, 2048, 4, 384, True), (1, 2048, 4, 512, True), (2, 192, 3, 1152, True))),
]
# bf16 gradients: each side sums exact bf16 products in fp32, in other
# orders, and rounds each gradient once; dS (and P for dV) is rounded to
# bf16 before the second product, and where the two sides' fp32 dS straddle
# a rounding boundary a term differs by one bf16 ulp of dS.  rtol 2^-6
# allows two bf16 ulps of the gradient.  atol and the RMS bar are set from
# the readings (NVIDIA H100 80GB HBM3, this phase): the worst error above
# the rtol term (``excess_over_rtol``) was 0.0004 over the four shapes, the
# error's RMS at most 1.8e-4 of the gradient's RMS, while the gradients'
# RMS is 0.04-0.09 at the llm shape: a bar near it would pass a fault
# confined to late rows or to the last tile.  atol 2e-3 is five times the
# worst excess; the RMS bar, 1e-3, five times the worst ratio, and a
# dropped 64-row tile of 2048 moves that ratio by some 0.1.
BWD_RTOL = 2.0**-6
BWD_ATOL = 2e-3
BWD_REL_RMS = 1e-3
#: rows also refereed against the exact gradient in f64 (bshd): the serve
#: prefill's shape (512 keys) at head_dim 384 and 512, in bf16.  BWD_ATOL's
#: basis is readings at 2048 keys; at 512 the probabilities, and so dS and
#: its bf16 rounding, are some four times larger, and one element of dK at
#: d384 read 0.0027 past the rtol term, over BWD_ATOL (NVIDIA H100 80GB
#: HBM3, 700.00 W, this phase).  Against the exact gradient the kernel and
#: the plain version read the same largest error (0.0112-0.0211) and RMS
#: errors within 0.01% of each other: the two sides differ by where they
#: round, not by accuracy.  So a gradient of these rows that lands past the
#: bar is held instead to the referee: its RMS and largest errors against
#: the exact gradient within F64_RATIO of the plain version's, with the RMS
#: bar above still held against the plain version.  A dropped or misplaced
#: 64-row tile moves the kernel's RMS error against the exact gradient by
#: orders of magnitude
BWD_F64_SHAPES = {(8, 512, 4, 384), (8, 512, 4, 512)}
F64_RATIO = 1.05
#: the gradients' (atol, rtol) by dtype: f16 at bf16's (f16 rounds dS and P
#: finer); f32 at the JAX package's f32 gradient bar, 2e-4 both
#: (tests/test_flash_attention.py:110), against the plain version with TF32
#: off, the RMS bar as bf16's
GRAD_BARS = {torch.bfloat16: (BWD_ATOL, BWD_RTOL), torch.float16: (BWD_ATOL, BWD_RTOL),
             torch.float32: (2e-4, 2e-4)}
# The autograd Function against autograd through the plain forward, which
# keeps dS in fp32 and takes delta from the unrounded output: every summand
# differs by a bf16 rounding, so near zero the difference grows with the
# row's terms, not the entry's value.  Its readings at the llm shape: excess
# over the rtol term 0.0059, RMS ratio 0.0034; its bars are twice those.
FN_ATOL = 0.012
FN_REL_RMS = 0.007
# the llm shape, a long causal one and the llm shape at head_dim 256, for
# timing, in bf16; the llm shape and its head_dim 256 in f16 and f32
BWD_TIMED = [(*LLM_SHAPE, torch.bfloat16), (2, 4096, 8, 128, torch.bfloat16),
             (*LLM_SHAPE_D256, torch.bfloat16),
             *((*shape, dt) for dt in NEW_DTYPES for shape in (LLM_SHAPE, LLM_SHAPE_D256)),
             # the llm shape at head_dim 384 and 512, in bf16 and f16
             *((1, 2048, 4, d, dt) for dt in (torch.bfloat16, torch.float16)
               for d in WIDE_HEAD_DIMS),
             # the streamed instantiations: the llm shape at head_dim 1024 (two
             # heads) in bf16 and f16, and at 512 (four heads) in f32, and the
             # f32 backward's cluster of eight at 1024 (two heads)
             (1, 2048, 2, 1024, torch.bfloat16), (1, 2048, 2, 1024, torch.float16),
             (1, 2048, 4, 512, torch.float32), (1, 2048, 2, 1024, torch.float32)]
# train parity: the two steps' losses agree within the JAX package's bar for
# the same comparison (tests/test_flash_attention.py:187).  The gradients of
# the same loss from the same weights, auto (flash kernels) against ring
# (plain fp32 blocking), are compared leaf by leaf, wqkv's Q, K and V
# columns apart: the norm of their difference over the ring gradient's norm.
# bf16 roundings downstream of attention differ between the two paths: the
# readings were 0.004-0.011 for every leaf but the last layer's Q and K
# columns, 0.022 and 0.025 (NVIDIA H100 80GB HBM3, this phase); the bar is
# twice the worst.  A leaf whose attention gradient went missing reads 1.  The
# updated bf16 weights p - lr g, with lr 1e-3, differ only where the two
# gradients' differences move a rounding: at most a bf16 ulp, held to two
# (rtol 2^-6); most weights do not move at this lr, hence the gradients.
TRAIN_LOSS_ATOL = 0.05
TRAIN_GRAD_REL = 0.05
TRAIN_PARAM_RTOL = 2.0**-6
TRAIN_PARAM_ATOL = 1e-6


#: spin kernels launched inside a trace before the traced work, and left out
#: of what it reports: late in a long run a trace has missed the first five
#: kernels of an llm step (its first flash forward among them), for a reason
#: not found, so the trace's first kernels are spent on these.  The profile
#: phases also hold the trace's counts against the wrappers' own launches, so
#: a trace that still loses kernels fails as a fault of the trace
TRACE_WARMUP_KERNELS = 8


def _warm_trace() -> None:
    for _ in range(TRACE_WARMUP_KERNELS):
        torch.cuda._sleep(1000)  # ``spin_kernel``, some microseconds
    torch.cuda.synchronize()


def _traced_kernels(events, width: int, after: float | None = None) -> dict:
    """Device time and calls by kernel name among a trace's events, the
    warm-up's spin kernels and the regions a user annotated
    (``Optimizer.step#SGD.step``) left out; with ``after``, only the
    kernels that start at or after it."""
    kernels = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation
                or "spin_kernel" in e.name or (after is not None and e.time_range.start < after)):
            continue
        k = kernels.setdefault(e.name[:width], {"ms": 0.0, "calls": 0})
        k["ms"] += e.time_range.elapsed_us() / 1e3
        k["calls"] += 1
    return kernels


def _after_lead(step, before=None) -> tuple[dict, float]:
    """Device time and calls by kernel name of one ``step()`` under
    torch.profiler, and its host wall time in ms.  A lead ``step()`` and
    the spin kernels of ``_warm_trace`` go first in the same trace, and the
    step's kernels are those that start after the last spin kernel ends: a
    trace that drops kernels at its head (as traces begun at a graph
    replay, and late in a long run, have) drops the lead step's.
    ``before`` runs between the spins and the step."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        step()
        _warm_trace()
        if before is not None:
            before()
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spins = [e.time_range.end for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" in e.name]
    return (_traced_kernels(events, 100, after=max(spins)) if spins else {}), wall_ms


#: perf_counter at the start of main(): each phase's line carries its
#: seconds since then (``t_s``), so a run's time splits by phase
_START: float | None = None
#: phases that run at once in threads print whole lines
_EMIT_LOCK = threading.Lock()


def emit(obj: dict) -> None:
    if "phase" in obj and _START is not None:
        obj = {**obj, "t_s": time.perf_counter() - _START}
    with _EMIT_LOCK:
        print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, the best replay
    over ``iters``.  Unlike a timed loop of calls this leaves out the host's
    time to launch each call, which for a kernel of some ten microseconds
    behind a Python wrapper is the larger part."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peak_tflops = peak_tflops_for(name)
    peak_gbps = peak_hbm_gbps_for(name)
    if peak_tflops is None or peak_gbps is None:
        raise RuntimeError(f"no peak table entry for {name!r} (device.py)")
    info = {
        "phase": "device", "nvidia_smi": smi, "torch_name": name,
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "peak_bf16_tflops": peak_tflops,
        "peak_f16_tflops": peak_tflops_for(name, torch.float16),
        "peak_f32_tflops": peak_tflops_for(name, torch.float32),
        "peak_hbm_gbps": peak_gbps,
    }
    emit(info)
    return info


def phase_build() -> None:
    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    def ptxas_lines(out: str) -> list[str]:
        # registers on the "ptxas info" lines, spills on the lines after them
        return [ln.strip() for ln in out.splitlines() if "ptxas info" in ln or "spill" in ln]

    # one nvcc for each source and dtype, all at once: the wgmma sources as
    # bf16 and as f16, the FFMA sources for f32
    builds = {(name, dt): (fn, dt) for dt in DT_NAME
              for name, fn in (("matmul", matmul.build), ("flash", flash_attention.build),
                               ("flash_bwd", flash_attention.build_bwd))}
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        running = {key: pool.submit(timed, *job) for key, job in builds.items()}
        exporter = pool.submit(timed, native.build_native)
        done = {key: job.result() for key, job in running.items()}
        _, exporter_s = exporter.result()
    ptxas = {key: out[1] for key, (out, _) in done.items()}
    seconds = {f"{name}_{DT_NAME[dt]}": round(s, 3) for (name, dt), (_, s) in done.items()}
    props = r"\d+ bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\s+" \
            r"ptxas info\s+: Used (\d+) registers"

    def streamed_entries(dt: torch.dtype, infix: str, head_dim: int) -> list[dict]:
        """The streamed instantiations' ptxas entries in ``dt``'s libraries
        (one of each kernel, head_dim an argument), with their configs at
        ``head_dim``."""
        return [
            {"kernel": kernel, "registers": int(regs), "spill_bytes": int(st) + int(ld),
             **(flash_attention.fwd_config(head_dim, 1, dtype=dt) if kernel == "fwd" else
                flash_attention.bwd_config(kernel, head_dim, dtype=dt))}
            for key, pattern in (("flash", f"flash_(fwd){infix}_streamed_kernel"),
                                 ("flash_bwd", f"flash_bwd_(dq|dkv){infix}_streamed_kernel"))
            for kernel, st, ld, regs in re.findall(
                r"Function properties for \S*" + pattern + r"\S*\s+" + props, ptxas[(key, dt)])
        ]
    wgmma = {}
    for dt in (torch.bfloat16, torch.float16):
        name = DT_NAME[dt]
        mm_ptxas = ptxas[("matmul", dt)]
        config = matmul.kernel_config(dt)
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", mm_ptxas)]
        # ptxas reports each entry function's registers and spills in turn
        entries = re.findall(r"Function properties for \S*flash_fwd_kernelILi(\d+)ELi(\d+)E\S*\s+"
                             + props, ptxas[("flash", dt)])
        flash_fwd = [
            {"head_dim": int(d), "registers": int(regs), "spill_bytes": int(st) + int(ld),
             "kv_split": int(split), **flash_attention.fwd_config(int(d), int(split), dtype=dt)}
            for d, split, st, ld, regs in entries
        ]
        bwd_entries = re.findall(r"Function properties for \S*flash_bwd_(dq|dkv)_kernelILi(\d+)E\S*\s+"
                                 + props, ptxas[("flash_bwd", dt)])
        flash_bwd = [
            {"kernel": kernel, "head_dim": int(d), "registers_at_launch": int(regs),
             "spill_bytes": int(st) + int(ld),
             **flash_attention.bwd_config(kernel, int(d), dtype=dt)}
            for kernel, d, st, ld, regs in bwd_entries
        ]
        wgmma[name] = {
            "ptxas": ptxas_lines(mm_ptxas),
            # ptxas reports the registers a thread is launched with;
            # setmaxnreg then moves them between the warpgroups' roles
            "matmul": {
                "config": config,
                "registers_at_launch": [int(n) for n in re.findall(r"Used (\d+) registers", mm_ptxas)],
                "registers_by_role": {"producer": config["producer_regs"],
                                      "consumers": config["consumer_regs"]},
                "dynamic_smem_bytes": config["smem_bytes"],
                "spill": f"{sum(spills)} bytes spill" if spills else "not reported",
            },
            "flash_ptxas": ptxas_lines(ptxas[("flash", dt)]),
            "flash_fwd": flash_fwd,
            "flash_bwd_ptxas": ptxas_lines(ptxas[("flash_bwd", dt)]),
            # under setmaxnreg (every instantiation but dQ at head_dim 64) a
            # thread launches with 168 registers, and the producer
            # warpgroup's and the consumers' counts are set in the kernel
            "flash_bwd": flash_bwd,
            # configs at head_dim 1024 (chunks: head_dim / 128)
            "flash_streamed": streamed_entries(dt, "", 1024),
        }
    f32 = torch.float32
    f32_entries = {
        key: [{"kernel": kernel, "head_dim": int(d), "registers": int(regs),
               "spill_bytes": int(st) + int(ld)}
              for kernel, d, st, ld, regs in re.findall(
                  r"Function properties for \S*flash_(fwd|bwd_dq|bwd_dkv)_f32_kernelILi(\d+)E\S*\s+"
                  + props, ptxas[(key, f32)])]
        for key in ("flash", "flash_bwd")
    }
    mm32 = re.findall(r"Function properties for \S*matmul_f32_kernel\S*\s+" + props,
                      ptxas[("matmul", f32)])
    # the f32 streamed tiling now runs the backward past 1024 only
    f32_streamed = streamed_entries(f32, "_f32", 1152)
    # the f32 backward's cluster tiling, its config at 512 and the clusters
    # of 4 and 8 CTAs (head_dim 512 and 1024) the card holds at once
    f32_cluster = [
        {"kernel": kernel, "registers": int(regs), "spill_bytes": int(st) + int(ld),
         **flash_attention.bwd_config(kernel, 512, dtype=f32),
         "max_active_clusters": {n: flash_attention.bwd_max_clusters(kernel, 128 * n)
                                 for n in (4, 8)}}
        for kernel, st, ld, regs in re.findall(
            r"Function properties for \S*flash_bwd_(dq|dkv)_f32_cluster_kernel\S*\s+" + props,
            ptxas[("flash_bwd", f32)])
    ]
    emit({
        "phase": "build", **{f"{key}_s": s for key, s in seconds.items()},
        "exporter_cc_s": round(exporter_s, 3),
        # the bf16 libraries' report as before, then f16's and f32's
        **wgmma["bf16"], "f16": wgmma["f16"],
        "f32": {
            "matmul": {"config": matmul.kernel_config(f32),
                       "registers": [int(regs) for _, _, regs in mm32],
                       "spill_bytes": sum(int(st) + int(ld) for st, ld, _ in mm32)},
            "flash_fwd": [{**e, **flash_attention.fwd_config(e["head_dim"], 1, dtype=f32)}
                          for e in f32_entries["flash"]],
            "flash_bwd": [{**e, **flash_attention.bwd_config(e["kernel"][4:], e["head_dim"],
                                                             dtype=f32)}
                          for e in f32_entries["flash_bwd"]],
            # configs at head_dim 1152 (chunks: head_dim / 128)
            "flash_streamed": f32_streamed,
            "flash_bwd_cluster": f32_cluster,
        },
    })
    # one streamed instantiation of each kernel in each library, no spill
    for name, streamed in (("bf16", wgmma["bf16"]["flash_streamed"]),
                           ("f16", wgmma["f16"]["flash_streamed"]), ("f32", f32_streamed)):
        if sorted(e["kernel"] for e in streamed) != ["dkv", "dq", "fwd"] or any(
                e["spill_bytes"] for e in streamed):
            raise AssertionError(f"the {name} streamed kernels' ptxas report: {streamed}")
    # the f32 backward's two cluster kernels, no spill, each cluster of 4
    # and of 8 CTAs resident somewhere on the card
    if sorted(e["kernel"] for e in f32_cluster) != ["dkv", "dq"] or any(
            e["spill_bytes"] or min(e["max_active_clusters"].values()) < 1 for e in f32_cluster):
        raise AssertionError(f"the f32 cluster kernels' ptxas report: {f32_cluster}")
    for dt in (torch.bfloat16, torch.float16):
        name, head_dims = DT_NAME[dt], flash_attention.HEAD_DIMS[dt]
        flash_fwd, flash_bwd = wgmma[name]["flash_fwd"], wgmma[name]["flash_bwd"]
        fwd_count = sum(len(flash_attention.fwd_splits(d, dt)) for d in head_dims)
        if len(flash_fwd) != fwd_count or any(e["spill_bytes"] for e in flash_fwd):
            raise AssertionError(f"the {name} flash forward's ptxas report: {flash_fwd}")
        # setmaxnreg.inc waits for registers the producer's .dec gives up: at
        # 384 threads they add up only from exactly 168 a thread at launch
        if len(flash_bwd) != 2 * len(head_dims) or any(
            e["spill_bytes"] or (e["consumer_regs"] and e["registers_at_launch"] != 168)
            for e in flash_bwd
        ):
            raise AssertionError(f"the {name} flash backward's ptxas report: {flash_bwd}")
    # a product serialized for want of registers (C7512) or under a branch
    # (C7520)
    if any("are serialized" in ptxas[(kind, dt)] for kind in ("flash", "flash_bwd")
           for dt in (torch.bfloat16, torch.float16)):
        raise AssertionError("ptxas serialized a flash kernel's wgmma")
    n = len(flash_attention.HEAD_DIMS[f32])
    if len(f32_entries["flash"]) != n or len(f32_entries["flash_bwd"]) != 2 * n or len(mm32) != 1:
        raise AssertionError(f"the f32 kernels' ptxas report: {f32_entries}, {mm32}")


def phase_parity() -> dict[str, float]:
    """The GEMM of each dtype against its plain version; returns the worst
    absolute error by dtype name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = dict.fromkeys(DT_NAME.values(), 0.0)
    rows = []
    for m, k, n, dt in PARITY_SHAPES:
        atol, rtol = GEMM_BARS[dt]
        a = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        b = torch.randn(k, n, generator=gen, device="cuda").to(dt)
        got = matmul_kernel(a, b)
        torch.cuda.synchronize()
        want = matmul_reference(a, b)
        diff = (got.float() - want.float()).abs()
        bad = int((diff > atol + rtol * want.float().abs()).sum())
        worst_at = int(diff.argmax())
        err = float(diff.view(-1)[worst_at])
        # the reference's value where the error is largest, and the error in
        # units of that value's ulp in the dtype
        at = float(want.view(-1)[worst_at])
        ulp = 2.0 ** (math.floor(math.log2(abs(at))) - MANTISSA_BITS[dt]) if at else float("nan")
        rows.append({"mkn": [m, k, n], "dtype": DT_NAME[dt], "max_abs_err": err,
                     "out_of_tol": bad, "want_at_max_err": at, "ulps_at_max_err": err / ulp})
        worst[DT_NAME[dt]] = max(worst[DT_NAME[dt]], err)
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel disagrees with its plain version at {(m, k, n)}: {rows[-1]}")
    refused = {}
    cases = {
        "f64": (torch.ones(128, 128, device="cuda", dtype=torch.float64),
                torch.ones(128, 128, device="cuda", dtype=torch.float64)),
        "mixed": (torch.ones(128, 128, device="cuda"),
                  torch.ones(128, 128, device="cuda", dtype=torch.float16)),
        "unaligned": (
            torch.ones(100, 128, device="cuda", dtype=torch.bfloat16),
            torch.ones(128, 128, device="cuda", dtype=torch.bfloat16),
        ),
    }
    for case, (a, b) in cases.items():
        try:
            matmul_kernel(a, b)
        except (TypeError, ValueError) as e:
            refused[case] = type(e).__name__
        else:
            raise AssertionError(f"matmul_kernel took a {case} operand")
    emit({"phase": "parity", "bars": {DT_NAME[dt]: bar for dt, bar in GEMM_BARS.items()},
          "shapes": rows, "refused": refused})
    return worst


def _peak(dtype: torch.dtype) -> tuple[float, str]:
    """The card's peak for ``dtype`` (device.py's table) and its name: the
    tensor cores' dense rate for bf16 and f16, the CUDA cores' for f32 (FFMA
    kernels)."""
    peak = peak_tflops_for(torch.cuda.get_device_name(0), dtype)
    where = "CUDA cores (FFMA)" if dtype == torch.float32 else "tensor cores, dense"
    return peak, f"{DT_NAME[dtype]} {peak} TFLOP/s, {where}"


def _gemm_timing(dt: torch.dtype, peak_gbps: float, kernel_iters: int, plain_iters: int) -> dict:
    """The GEMM of ``dt`` at 4096^3 by CUDA events, in turns (plain,
    kernel, library, kernel, plain), beside its bound and torch.matmul in
    the same dtype with TF32 off (a yardstick the port never calls)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(SIZE, SIZE, generator=gen, device="cuda").to(dt)
    b = torch.randn(SIZE, SIZE, generator=gen, device="cuda").to(dt)
    flops = 2.0 * SIZE**3
    nbytes = 3 * SIZE * SIZE * a.element_size()  # A and B read once, C written once
    peak, named = _peak(dt)
    ms_by_ops = flops / (peak * 1e12) * 1e3
    ms_by_bytes = nbytes / (peak_gbps * 1e9) * 1e3
    # turns: plain, kernel, library, kernel, plain — compare within one call
    plain = [cuda_time_ms(lambda: matmul_reference(a, b), plain_iters)]
    kernel = [cuda_time_ms(lambda: matmul_kernel(a, b), kernel_iters)]
    library = cuda_time_ms(lambda: torch.matmul(a, b), kernel_iters)
    kernel.append(cuda_time_ms(lambda: matmul_kernel(a, b), kernel_iters))
    plain.append(cuda_time_ms(lambda: matmul_reference(a, b), plain_iters))
    config = matmul.kernel_config(dt)
    tiles = (SIZE // config["tile_m"]) * -(-SIZE // config["tile_n"])
    out = {
        "mkn": [SIZE, SIZE, SIZE], "dtype": DT_NAME[dt],
        "tile": [config["tile_m"], config["tile_n"], config["tile_k"]],
        "stages": config["stages"], "tiles": tiles,
        "ms": min(kernel), "ms_runs": kernel,
        "tflops": flops / min(kernel) / 1e9,
        "plain_ms": min(plain), "plain_ms_runs": plain,
        "library_ms": library, "library": f"torch.matmul {DT_NAME[dt]}, TF32 off",
        "bound_ms": max(ms_by_ops, ms_by_bytes),
        "bound_by": "operations" if ms_by_ops >= ms_by_bytes else "bytes",
        "bound_ops_ms": ms_by_ops, "bound_bytes_ms": ms_by_bytes, "bound_peak": named,
    }
    out["fraction_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def phase_timing(peak_gbps: float) -> dict:
    out = {"phase": "timing", **_gemm_timing(torch.bfloat16, peak_gbps, 50, 10)}
    out["ctas"] = min(out["tiles"], torch.cuda.get_device_properties(0).multi_processor_count)
    out["by_dtype"] = {DT_NAME[dt]: _gemm_timing(dt, peak_gbps, iters, 4)
                       for dt, iters in zip(NEW_DTYPES, (50, 10))}
    emit(out)
    return out


def phase_loadgen(knob_dir: str):
    gen = MatmulLoadGen(size=SIZE, use_kernel=True, intensity=1.0, window=3.0, device="cuda:0")
    gen.intensity_file = str(Path(knob_dir) / "intensity")  # absent: API knob only
    gen.warmup()
    rows = []
    for duty in (1.0, 0.25):
        gen.set_intensity(duty)
        gen.run_for(gen.window + 1.0)  # flush the window at the new duty
        matmul_kernel.launches = 0
        steps_before = gen.stats().steps
        stats = gen.run_for(2.0)
        steps = stats.steps - steps_before
        expected = steps * gen.burst_iters(duty)
        row = {
            "duty": duty, "utilization": stats.utilization, "steps": steps,
            "launches": matmul_kernel.launches, "expected_launches": expected,
            "achieved_tflops": stats.achieved_tflops,
            "sustained_tflops": stats.sustained_tflops,
            "mxu_utilization": gen.mxu_utilization(),
        }
        rows.append(row)
        if matmul_kernel.launches != expected or steps == 0:
            raise AssertionError(f"kernel launches do not match the products run: {row}")
        if abs(stats.utilization - 100.0 * duty) > 10.0:
            raise AssertionError(f"utilization does not track the commanded duty: {row}")
    probe = gen._burst(gen.iters_per_burst)
    if not math.isfinite(probe):
        raise AssertionError(f"the product chain went non-finite: {probe}")
    dwell = gen.measure_dwell_tflops()
    out = {"phase": "loadgen", "size": SIZE, "iters_per_burst": gen.iters_per_burst,
           "runs": rows, "probe": probe, "dwell_tflops": dwell,
           "dwell_mfu_pct": 100.0 * dwell / gen.peak_tflops,
           "band_edge_pct": TARGET * 1.1}
    emit(out)
    # the tensor-core HPA scales up only above its target times its 10% band
    if out["dwell_mfu_pct"] <= out["band_edge_pct"]:
        raise AssertionError(f"the GEMM cannot drive the tensor-core loop: {out}")
    return gen, out["dwell_mfu_pct"]


def phase_profile(gen) -> dict:
    """Where one full-length burst's device time goes: ``torch.profiler``
    over one burst at full duty, device time summed by kernel name, and the
    device's idle share of the burst's host wall time (profiled: tracing
    adds host cost, so the share is an upper bound)."""
    gen._burst(8)  # warm the profiler-free path first
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _warm_trace()
        matmul_kernel.launches = 0
        t0 = time.perf_counter()
        gen._burst(gen.iters_per_burst)
        wall_ms = (time.perf_counter() - t0) * 1e3
    wrapper_launches = matmul_kernel.launches
    kernels = _traced_kernels(prof.events(), 80)
    busy_ms = sum(k["ms"] for k in kernels.values())

    def calls_of(name: str) -> int:
        return sum(k["calls"] for key, k in kernels.items() if name in key)

    out = {
        "phase": "profile", "products": gen.iters_per_burst, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "gemm_calls": calls_of("matmul_wgmma_kernel"), "wrapper_launches": wrapper_launches,
        # the renorm y.mul_(scale), PyTorch's elementwise kernel; the probe's
        # cast is its copy kernel
        "renorm_calls": calls_of("elementwise_kernel") - calls_of("copy"),
        "kernels": kernels,
    }
    emit(out)
    if wrapper_launches != gen.iters_per_burst:
        raise AssertionError(f"the profiled burst launched {wrapper_launches} GEMMs, "
                             f"not {gen.iters_per_burst}")
    if out["gemm_calls"] != wrapper_launches:
        raise AssertionError(f"the trace lost kernels: it shows {out['gemm_calls']} of the "
                             f"wrapper's {wrapper_launches} GEMM launches")
    if out["renorm_calls"] != gen.iters_per_burst:
        raise AssertionError(f"the profiled burst is not one GEMM and one renorm a product: {out}")
    return out


#: bench.py's scale-down budget on a chip and its flaps (SCALE_DOWN_BUDGET_S
#: ["real_chip"], SCALE_DOWN_MAX_FLAPS), and its overshoot bar (OVERSHOOT_MAX)
SCALE_DOWN_BUDGET_S = 255.0
SCALE_DOWN_MAX_FLAPS = 0
OVERSHOOT_MAX = 0


def phase_loop(gen) -> tuple[int, float]:
    """The headline loop on the kernel, as bench.py runs it: the HPA reads
    the tensor-core average, the kernel's MFU, which phase_loadgen showed
    can clear the band above the target.  The series holds both recorded
    averages, tensor-core and duty cycle.  Once all 4 replicas run the load
    drops to 0.08 devices, and the drain back to one replica must end
    within bench.py's 255 s without a flap."""
    matmul_kernel.launches = 0
    t0 = time.perf_counter()
    result = run_headline_trial(gen)
    wall = time.perf_counter() - t0
    launches = matmul_kernel.launches
    if launches <= 0:
        raise AssertionError("the closed loop launched the kernel no time")
    emit({
        "phase": "loop", "hpa_metric": TENSORCORE_SERIES, "time_scale": 1.0,
        "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s,
        "scale_down_s": result.scale_down_s, "scale_down_budget_s": SCALE_DOWN_BUDGET_S,
        "scale_down_flaps": result.scale_down_flaps,
        "scale_down_max_flaps": SCALE_DOWN_MAX_FLAPS, "wall_s": wall,
        "launches": launches,
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), tc, duty] for t, tc, duty in result.series],
    })
    if (result.scale_down_s is None or result.scale_down_s > SCALE_DOWN_BUDGET_S
            or result.scale_down_flaps > SCALE_DOWN_MAX_FLAPS):
        raise AssertionError(
            f"the drain took {result.scale_down_s} s with {result.scale_down_flaps} flaps "
            f"(bars: {SCALE_DOWN_BUDGET_S} s, {SCALE_DOWN_MAX_FLAPS} flaps)")
    return launches, result.scale_up_s


def phase_overshoot(gen) -> int:
    """bench.py's overshoot probe on the headline loop around the GEMM, at
    time scale 1: one device of load, whose steady need is 3 of 4 replicas
    where each running pod reads 100/n (the HPA reads the duty-cycle
    average).  Held to bench.py's bar on a chip, OVERSHOOT_MAX: the 3 pods
    run 3 s before the next sync, and that sync must read the load's 3 s
    window below the band edge 44.  The GEMM's launches are returned."""
    matmul_kernel.launches = 0
    lines = []
    t0 = time.perf_counter()
    overshoot = run_headline_overshoot_probe(gen, log=lines.append)
    wall = time.perf_counter() - t0
    launches = matmul_kernel.launches
    emit({"phase": "overshoot", "hpa_metric": DUTY_SERIES, "time_scale": 1.0,
          "need": PROBE_NEED, "overshoot": overshoot, "overshoot_max": OVERSHOOT_MAX,
          "band_edge": TARGET * 1.1, "wall_s": wall, "launches": launches, "syncs": lines})
    if launches <= 0:
        raise AssertionError("the overshoot probe launched the kernel no time")
    if overshoot > OVERSHOOT_MAX:
        raise AssertionError(f"the probe overshot by {overshoot} (bar: {OVERSHOOT_MAX}): {lines}")
    return launches


#: exporter/nvml.py's structs, by their nvml.h names, and its constants
NVML_STRUCTS = {
    "nvmlUtilization_t": nvml.Utilization, "nvmlMemory_v2_t": nvml.MemoryV2,
    "nvmlGpmSupport_t": nvml.GpmSupport, "nvmlGpmMetric_t": nvml.GpmMetric,
    "nvmlGpmMetricsGet_t": nvml.GpmMetricsGet,
}
NVML_CONSTANTS = {
    "nvmlMemory_v2": nvml.MEMORY_V2_VERSION,
    "NVML_GPM_METRIC_DRAM_BW_UTIL": nvml.NVML_GPM_METRIC_DRAM_BW_UTIL,
    "NVML_GPM_METRIC_MAX": nvml.NVML_GPM_METRIC_MAX,
    "NVML_GPM_METRICS_GET_VERSION": nvml.NVML_GPM_METRICS_GET_VERSION,
    "NVML_GPM_SUPPORT_VERSION": nvml.NVML_GPM_SUPPORT_VERSION,
    "NVML_ERROR_NOT_SUPPORTED": nvml.NVML_ERROR_NOT_SUPPORTED,
    "NVML_ERROR_NOT_FOUND": nvml.NVML_ERROR_NOT_FOUND,
    "NVML_ERROR_INVALID_ARGUMENT": nvml.NVML_ERROR_INVALID_ARGUMENT,
    "NVML_TEMPERATURE_GPU": nvml.NVML_TEMPERATURE_GPU,
    "NVML_DEVICE_UUID_V2_BUFFER_SIZE": nvml.NVML_DEVICE_UUID_V2_BUFFER_SIZE,
}
NVML_HEADERS = [Path("/usr/local/cuda/include"), Path("/usr/local/cuda/targets/x86_64-linux/include")]
# nvidia-smi against NvmlSource, read back to back with the generator idle
SMI_BARS = {"memory.total": 1.0, "memory.used": 256.0, "temperature.gpu": 3.0, "power.draw": 25.0}
#: NVML's duty cycle: its least mean at full duty, and its greatest distance
#: from the generator's own at knob 0.25
NVML_FULL_DUTY = 90.0
NVML_KNOB = 0.25
NVML_KNOB_POINTS = 15.0


def nvml_layout() -> dict:
    """Every size, offset and constant of exporter/nvml.py against a probe
    compiled with the card's nvml.h; raises on any difference."""
    header_dir = next((d for d in NVML_HEADERS if (d / "nvml.h").exists()), None)
    if header_dir is None:
        raise FileNotFoundError(f"nvml.h under none of {NVML_HEADERS}")
    lines, want = [], {}
    for cname, cls in NVML_STRUCTS.items():
        lines.append(f'printf("{cname} %zu\\n", sizeof({cname}));')
        want[cname] = ctypes.sizeof(cls)
        for field, *_ in cls._fields_:
            lines.append(f'printf("{cname}.{field} %zu\\n", offsetof({cname}, {field}));')
            want[f"{cname}.{field}"] = getattr(cls, field).offset
    for name, value in NVML_CONSTANTS.items():
        lines.append(f'printf("{name} %lld\\n", (long long)({name}));')
        want[name] = value
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.c"
        src.write_text("#include <stddef.h>\n#include <stdio.h>\n#include <nvml.h>\n"
                       "int main(void) {\n" + "\n".join(lines) + "\nreturn 0;\n}\n")
        subprocess.run(["gcc", f"-I{header_dir}", str(src), "-o", f"{tmp}/probe"],
                       check=True, capture_output=True, text=True, timeout=120)
        out = subprocess.run([f"{tmp}/probe"], check=True, capture_output=True, text=True,
                             timeout=60).stdout
    got = {k: int(v) for k, v in (ln.rsplit(" ", 1) for ln in out.splitlines())}
    wrong = {k: {"nvml.h": got.get(k), "ctypes": v} for k, v in want.items() if got.get(k) != v}
    if wrong:
        raise AssertionError(f"exporter/nvml.py disagrees with {header_dir}/nvml.h: {wrong}")
    return {"header": str(header_dir / "nvml.h"), "checked": len(want)}


def _smi(index: int, fields: list[str]) -> dict[str, float]:
    line = subprocess.run(
        ["nvidia-smi", "-i", str(index), f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return dict(zip(fields, (float(v) for v in line.split(","))))


def _settle(source: NvmlSource, index: int, most_s: float = 30.0) -> float:
    """Wait until the idle card's power has settled: NVML's reading moves
    less than 5 W over a second (a card that just ran at 700 W falls for
    several seconds), at most ``most_s``.  Returns the seconds waited."""
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < most_s:
        power = next(c for c in source.sample() if c.accel_index == index).power_w
        if last is not None and power is not None and abs(power - last) < 5.0:
            break
        last = power
        time.sleep(1.0)
    return time.monotonic() - t0


def _dwell(source: NvmlSource, index: int, gen, seconds: float, lead: float = 1.0) -> list:
    """Sweep ``source`` every half second for ``seconds`` after ``lead``
    while the generator runs in its own thread; returns (NVML's sample,
    the generator's utilization) at each sweep."""
    worker = LoadThread(gen.step).start()
    rows = []
    try:
        time.sleep(lead)
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            chip = next(c for c in source.sample() if c.accel_index == index)
            rows.append((chip, gen.utilization()))
            worker.check()
            time.sleep(0.5)
    finally:
        worker.stop()
    return rows


def phase_nvml(gen) -> dict[int, tuple[str, str]]:
    """NVML beside nvidia-smi and beside the generator's own readings, and a
    kubelet response resolved through it.  Returns the decoded attribution,
    which node_loop uses."""
    uuid = f"GPU-{torch.cuda.get_device_properties(gen.device).uuid}"
    layout = nvml_layout()
    source = NvmlSource()
    try:
        index = source.uuid_to_index(uuid)
        if index is None:
            raise AssertionError(f"NVML knows no device {uuid} (torch {gen.device})")
        torch.cuda.synchronize()
        settled_s = _settle(source, index)
        # NVML, nvidia-smi, NVML: each of NVML's gauges as the mean of the
        # two readings around nvidia-smi's
        around = []
        for _ in range(2):
            chip = next(c for c in source.sample() if c.accel_index == index)
            around.append({"memory.total": chip.hbm_total_bytes / 2**20,
                           "memory.used": chip.hbm_usage_bytes / 2**20,
                           "temperature.gpu": chip.temperature_c, "power.draw": chip.power_w})
            if len(around) == 1:
                smi = _smi(index, list(SMI_BARS))
        idle = {k: {"nvml": (around[0][k] + around[1][k]) / 2, "nvidia_smi": smi[k], "bar": bar}
                for k, bar in SMI_BARS.items()}
        gen.set_intensity(1.0)
        full = _dwell(source, index, gen, 3.0)
        gen.set_intensity(NVML_KNOB)
        knob = _dwell(source, index, gen, 6.0, lead=gen.window + 1.0)
        readings = [c for c, _ in full + knob] + [chip]
        mapping = parse_list_response(
            kubelet_response({REAL_POD: [uuid], "tpu-test-other": ["7"]}),
            GPU_RESOURCE, resolve_uuid=source.uuid_to_index,
        )
        out = {
            "phase": "nvml", "nvml_index": index, "uuid": uuid,
            "cuda_ordinal": gen.device.index, "layout": layout, "settled_s": settled_s,
            "idle": idle,
            "full_duty": {"duty_cycle": [c.duty_cycle for c, _ in full],
                          "mean": sum(c.duty_cycle for c, _ in full) / len(full),
                          "generator": full[-1][1], "bar": NVML_FULL_DUTY,
                          "gpm_dram_bw_util": [c.hbm_bw_util for c, _ in full]},
            "knob": {"intensity": NVML_KNOB, "duty_cycle": [c.duty_cycle for c, _ in knob],
                     "mean": sum(c.duty_cycle for c, _ in knob) / len(knob),
                     "generator_mean": sum(u for _, u in knob) / len(knob),
                     "bar_points": NVML_KNOB_POINTS},
            "tensorcore_util": sorted({c.tensorcore_util for c in readings}, key=str),
            # GPM served the bandwidth from its second sample on
            "gpm_supported": any(c.hbm_bw_util is not None for c, _ in full),
            "power_w": [c.power_w for c, _ in full], "temperature_c": [c.temperature_c for c, _ in full],
            "kubelet_attribution": {str(k): list(v) for k, v in mapping.items()},
        }
    finally:
        source.close()
    emit(out)
    if any(abs(v["nvml"] - v["nvidia_smi"]) > v["bar"] for v in idle.values()):
        raise AssertionError(f"NVML disagrees with nvidia-smi: {idle}")
    if out["full_duty"]["mean"] < NVML_FULL_DUTY:
        raise AssertionError(f"NVML's duty cycle at full duty: {out['full_duty']}")
    if abs(out["knob"]["mean"] - out["knob"]["generator_mean"]) > NVML_KNOB_POINTS:
        raise AssertionError(f"NVML's duty cycle at knob {NVML_KNOB}: {out['knob']}")
    if out["tensorcore_util"] != [None]:
        raise AssertionError(f"NvmlSource set tensorcore_util: {out['tensorcore_util']}")
    if mapping != {index: ("default", REAL_POD), 7: ("default", "tpu-test-other")}:
        raise AssertionError(f"the kubelet response decoded to {mapping}")
    return mapping


def kubelet_response(pods: dict[str, list[str]]) -> bytes:
    """A ListPodResourcesResponse: each pod in namespace ``default`` with one
    container holding ``device_ids`` of nvidia.com/gpu."""
    body = b""
    for pod, ids in pods.items():
        devices = protowire.encode_string(1, GPU_RESOURCE) + b"".join(
            protowire.encode_string(2, i) for i in ids)
        container = protowire.encode_string(1, "main") + protowire.encode_string(2, devices)
        pod_msg = (protowire.encode_string(1, pod) + protowire.encode_string(2, "default")
                   + protowire.encode_string(3, container))
        body += protowire.encode_string(1, pod_msg)
    return body


def phase_node_loop(gen, attribution: dict[int, tuple[str, str]]) -> int:
    """The headline loop through the node exporter: NVML, the decoded
    kubelet attribution and the merged self-report.  The /metrics of the
    last ten scrapes of the exporter (the dwell at full duty, before all four
    replicas run), as the scraper fetched them over HTTP, must carry the
    power, temperature, tensor-core and duty-cycle families for the real
    pod."""
    sweeps: deque = deque(maxlen=10)
    fetch = trial.http_fetch

    def recording_fetch(port: int) -> str:
        text = fetch(port)
        values = {
            fam.name: s.value for fam in parse_text(text)
            for s in fam.samples if dict(s.labels).get("pod") == REAL_POD
        }
        sweeps.append((values, gen.utilization()))
        return text

    matmul_kernel.launches = 0
    t0 = time.perf_counter()
    trial.http_fetch = recording_fetch
    try:
        with tempfile.TemporaryDirectory() as telemetry_dir:
            result = run_node_headline_trial(gen, telemetry_dir, StaticAttributor(attribution))
    finally:
        trial.http_fetch = fetch
    wall = time.perf_counter() - t0
    launches = matmul_kernel.launches
    families = (TPU_CHIP_POWER, TPU_CHIP_TEMP, TPU_TENSORCORE_UTIL, TPU_DUTY_CYCLE)
    missing = [f for f in families for values, _ in sweeps if f not in values]

    def mean(values) -> float | None:
        values = list(values)
        return sum(values) / len(values) if values else None

    out = {
        "phase": "node_loop", "hpa_metric": TENSORCORE_SERIES, "time_scale": 1.0,
        "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": wall, "launches": launches,
        "dwell_scrapes": len(sweeps), "missing_families": sorted(set(missing)),
        "dwell": {
            "nvml_duty_cycle": mean(v.get(TPU_DUTY_CYCLE, math.nan) for v, _ in sweeps),
            "self_reported_duty_cycle": mean(u for _, u in sweeps),
            "merged_tensorcore_util": mean(v.get(TPU_TENSORCORE_UTIL, math.nan) for v, _ in sweeps),
            "power_w": mean(v.get(TPU_CHIP_POWER, math.nan) for v, _ in sweeps),
            "temperature_c": mean(v.get(TPU_CHIP_TEMP, math.nan) for v, _ in sweeps),
        },
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), tc, duty] for t, tc, duty in result.series],
    }
    emit(out)
    if launches <= 0:
        raise AssertionError("the node loop launched the kernel no time")
    if not sweeps or missing:
        raise AssertionError(f"/metrics lacked families for {REAL_POD}: {out['missing_families']}")
    return launches


def _qkv_views(b: int, s: int, h: int, d: int, gen: torch.Generator,
               dtype: torch.dtype = torch.bfloat16):
    """q, k, v as the prefill hands them to the kernel: [b, s, h, d] views of
    one fused [b, s, 3*h*d] projection."""
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    return tuple(t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_flash_parity() -> dict[str, float]:
    """The forward of each dtype against its plain version; returns the
    worst absolute error by dtype name, and of the chunked instantiations
    (head_dim 384 and 512) by dtype name and ``_wide``, of the streamed ones
    by dtype name and ``_streamed`` (``_kind``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {**dict.fromkeys(DT_NAME.values(), 0.0), "bf16_wide": 0.0, "f16_wide": 0.0,
             **{f"{name}_streamed": 0.0 for name in DT_NAME.values()}}
    rows = []
    for b, s, h, d, causal, with_lse, split, dt in FLASH_SHAPES:
        q, k, v = _qkv_views(b, s, h, d, gen, dt)
        if split is None:
            got = flash_attention_kernel(q, k, v, causal, with_lse=with_lse)
        else:
            got = flash_attention._launch_fwd(q, k, v, causal, with_lse, split)
        torch.cuda.synchronize()
        want = flash_attention_reference(q, k, v, causal, with_lse=with_lse)
        lse_err = None
        if with_lse:
            (got, got_lse), (want, want_lse) = got, want
            lse_err = float((got_lse - want_lse).abs().max())
        diff = (got.float() - want.float()).abs()
        rms_want = float(want.float().square().mean().sqrt())
        atol, rtol = FLASH_BARS[dt]
        row = {"bshd": [b, s, h, d], "causal": causal, "dtype": DT_NAME[dt],
               "kv_split": split or flash_attention.fwd_split(b * h, s, _sms(), d, dt),
               "max_abs_err": float(diff.max()),
               "out_of_tol": int((diff > atol + rtol * want.float().abs()).sum()),
               "rms_err_over_rms_want": float(diff.square().mean().sqrt()) / rms_want,
               "lse_max_abs_err": lse_err, "max_abs_out": float(want.float().abs().max()),
               "rms_out": rms_want}
        rows.append(row)
        key = _kind(d, dt)
        worst[key] = max(worst[key], row["max_abs_err"])
        if (
            row["out_of_tol"]
            or row["rms_err_over_rms_want"] > FLASH_REL_RMS
            or (lse_err is not None and lse_err > LSE_ATOL)
            or not bool(torch.isfinite(got.float()).all())
        ):
            emit({"phase": "flash_parity", "shapes": rows})
            raise AssertionError(f"flash kernel disagrees with its plain version: {row}")
    refused = {}
    bf16 = torch.bfloat16
    ok = torch.zeros(1, 128, 2, 128, device="cuda", dtype=bf16)
    cases = {
        "f64": (ok.double(), ok.double(), ok.double()),
        "mixed": (ok, ok.half(), ok),
        "seq_100": (ok[:, :100],) * 3,
        # past 512 only multiples of 128 (the streamed tilings' chunks)
        "head_dim_576": (torch.zeros(1, 128, 1, 576, device="cuda", dtype=bf16),) * 3,
        # f32 takes 64, 128, 256 and the multiples of 128 from 384 on
        "f32_head_dim_320": (torch.zeros(1, 128, 1, 320, device="cuda"),) * 3,
        "shape_mismatch": (ok, ok[:, :64], ok[:, :64]),
        "stride_not_8": (torch.zeros(1, 128, 2, 132, device="cuda", dtype=bf16)[..., :128],) * 3,
    }
    for case, (q, k, v) in cases.items():
        try:
            flash_attention_kernel(q, k, v, True)
        except (TypeError, ValueError) as e:
            refused[case] = type(e).__name__
        else:
            raise AssertionError(f"flash_attention_kernel took a {case} operand")
    try:
        flash_attention._launch_fwd(ok, ok, ok, True, False, 3)
    except ValueError as e:
        refused["kv_split_3"] = type(e).__name__
    else:
        raise AssertionError("the forward took three consumer warpgroups a CTA")
    for d in (256, *WIDE_HEAD_DIMS, 1024):
        wide = torch.zeros(1, 128, 1, d, device="cuda", dtype=bf16)
        try:
            flash_attention._launch_fwd(wide, wide, wide, True, False, 2)
        except ValueError as e:
            refused[f"d{d}_kv_split_2"] = type(e).__name__
        else:
            raise AssertionError(f"the forward took two consumer warpgroups a CTA at head_dim {d}")
    f32 = ok.float()
    try:
        flash_attention._launch_fwd(f32, f32, f32, True, False, 2)
    except ValueError as e:
        refused["f32_kv_split_2"] = type(e).__name__
    else:
        raise AssertionError("the f32 forward took two consumer warpgroups a CTA")
    emit({"phase": "flash_parity", "bars": {DT_NAME[dt]: bar for dt, bar in FLASH_BARS.items()},
          "lse_atol": LSE_ATOL, "rel_rms": FLASH_REL_RMS, "shapes": rows, "refused": refused})
    return worst


def flash_work(b: int, s: int, h: int, d: int, causal: bool,
               elem: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one forward: two products of 2 d operations
    per (batch-head, query, key) pair the causal loop visits, and Q, K, V
    read once and O written once, ``elem`` bytes an element (2: bf16, f16;
    4: f32)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return 4.0 * d * pairs, 4.0 * b * s * h * d * elem


def _sdpa_backend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backend scaled_dot_product_attention takes for causal attention
    on these operands (with their ``requires_grad``), by PyTorch's own
    dispatch rule: ``CUDNN_ATTENTION`` on the card at every timed shape.
    A trace of the call's kernels read the same early in the script but
    came back empty late in it."""
    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def phase_flash_timing(peak_gbps: float) -> list[dict]:
    """Each FLASH_TIMED row by graph replay, in turns, beside its bound, the
    plain version and SDPA; bf16 rows also on each tiling and in a host loop
    of launches.  Each row's bound names the peak it takes (``_peak``: f32's
    is the CUDA cores' FFMA rate, the kernel's own), and SDPA runs in the
    row's dtype with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for b, s, h, d, with_lse, views, dt in FLASH_TIMED:
        if views:
            q, k, v = _qkv_views(b, s, h, d, gen, dt)
        else:
            q, k, v = (
                torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
                for _ in range(3)
            )
        # scaled_dot_product_attention's layout, made before timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = flash_work(b, s, h, d, causal=True, elem=q.element_size())
        if with_lse:
            nbytes += b * h * s * 4  # the fp32 logsumexp, written once
        peak, named = _peak(dt)
        ms_by_ops = flops / (peak * 1e12) * 1e3
        ms_by_bytes = nbytes / (peak_gbps * 1e9) * 1e3
        iters = 100 if s <= 1024 else 50 if s <= 2048 else 20
        if dt == torch.float32:
            iters //= 5  # some ten to twenty times slower: as many milliseconds a replay

        def kernel_call():
            flash_attention_kernel(q, k, v, True, with_lse=with_lse)

        def library_call():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def plain_call():
            flash_attention_reference(q, k, v, True, with_lse=with_lse)

        # device time from graph replays, in turns: plain, kernel, library,
        # kernel, library, plain (f16 and f32: kernel, library, plain, once
        # each); then (bf16) on one and on two consumer warpgroups, and once
        # the kernel in a host loop of launches
        bf16 = dt == torch.bfloat16
        plain = [graph_time_ms(plain_call, 4)] if bf16 else []
        kernel = [graph_time_ms(kernel_call, iters)]
        library = [graph_time_ms(library_call, iters)]
        if bf16:
            kernel.append(graph_time_ms(kernel_call, iters))
            library.append(graph_time_ms(library_call, iters))
        plain.append(graph_time_ms(plain_call, 4))
        by_split = {
            split: graph_time_ms(
                lambda n=split: flash_attention._launch_fwd(q, k, v, True, with_lse, n), iters)
            for split in flash_attention.fwd_splits(d)
        } if bf16 else None
        host_loop = cuda_time_ms(kernel_call, iters) if bf16 else None
        row = {
            "bshd": [b, s, h, d], "dtype": DT_NAME[dt], "causal": True, "with_lse": with_lse,
            "qkv_views": views,
            "kv_split": flash_attention.fwd_split(b * h, s, _sms(), d, dt),
            "ms": min(kernel), "ms_runs": kernel, "ms_by_split": by_split,
            "ms_host_launch_loop": host_loop,
            "tflops": flops / min(kernel) / 1e9,
            "plain_ms": min(plain), "plain_ms_runs": plain,
            "library_ms": min(library), "library_ms_runs": library,
            "library": "F.scaled_dot_product_attention(is_causal=True)",
            "library_backend": _sdpa_backend(qt, kt, vt),
            "over_library": min(kernel) / min(library),
            "bound_ms": max(ms_by_ops, ms_by_bytes),
            "bound_by": "operations" if ms_by_ops >= ms_by_bytes else "bytes",
            "bound_ops_ms": ms_by_ops, "bound_bytes_ms": ms_by_bytes, "bound_peak": named,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        out.append(row)
    emit({"phase": "flash_timing", "shapes": out})
    return out


DWELL_CHECK_ITERS = 4
DWELL_NAIVE_REL_RMS = 0.06


def _chain_check(body, init: torch.Tensor) -> dict:
    """The chain ``timed_chain`` captures and replays against the same
    applications made eagerly."""
    want = init
    for _ in range(DWELL_CHECK_ITERS):
        want = body(want)
    got, _ = dwell.timed_chain(body, init, DWELL_CHECK_ITERS)
    torch.cuda.synchronize()
    return {"bit_identical": bool(torch.equal(got, want)), "rel_rms": _rel_rms(got, want),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "finite": bool(torch.isfinite(got).all())}


def phase_dwell(device: dict) -> dict:
    b, s, h, d = trial.ATTENTION_RATE_SHAPE
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(torch.bfloat16).cuda()
               for _ in range(3))
    with torch.no_grad():
        checks = {
            "flash": _chain_check(lambda x: flash_attention.flash_attention(x, k, v, causal=True), q),
            "naive": _chain_check(lambda x: reference_attention(x, k, v, causal=True), q),
        }
    del q, k, v
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    attention = trial.measure_attention_rates("cuda")
    attention_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernel = trial.measure_kernel_rates(MatmulLoadGen(size=SIZE, device="cuda:0"))
    kernel_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit({"phase": "dwell", "nvidia_smi": device["nvidia_smi"], "chain_checks": checks,
          "naive_rel_rms_tol": DWELL_NAIVE_REL_RMS, "attention": attention,
          "attention_s": attention_s, "kernel": kernel, "kernel_s": kernel_s})
    if not (checks["flash"]["bit_identical"] and checks["flash"]["finite"]):
        raise AssertionError(f"the captured flash chain differs from the eager one: {checks}")
    if not (checks["naive"]["rel_rms"] <= DWELL_NAIVE_REL_RMS and checks["naive"]["finite"]):
        raise AssertionError(f"the captured naive chain differs from the eager one: {checks}")
    rates = [attention["flash_tflops"], attention["naive_xla_tflops"],
             kernel["achieved_tflops"], kernel["achieved_tflops_8192"], kernel["pallas_tflops"]]
    # a wall-clock dwell is a lower bound: above the card's peak it is broken
    if not all(0 < r < device["peak_bf16_tflops"] for r in rates):
        raise AssertionError(f"a dwell rate outside (0, peak): {rates}")
    return {"attention": attention, "kernel": kernel}


def _cache_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    diff = (got.float() - want.float()).abs()
    bad = int((diff > SERVE_ATOL + SERVE_CACHE_RTOL * want.float().abs()).sum())
    return float(diff.max()), bad


def phase_serve_parity(gen: DecodeLoadGen) -> dict:
    """At the shipped sizes: (1) prefill's logits and cache against the same
    prompt fed through decode_step one position at a time; (2) the graph
    burst's tokens, position and cache against the eager burst's, exactly."""
    cfg, params, prompt = gen.cfg, gen._params, gen._prompt
    plen = prompt.shape[1]
    logits, cache = transformer.prefill(
        params, cfg, prompt, transformer.init_kv_cache(cfg, gen.batch, gen.device)
    )
    step_cache = transformer.init_kv_cache(cfg, gen.batch, gen.device)
    for pos in range(plen):
        step_logits, step_cache = transformer.decode_step(params, cfg, prompt[:, pos], step_cache, pos)
    torch.cuda.synchronize()
    logit_err = float((logits - step_logits).abs().max())
    k_err, k_bad = _cache_err(cache["k"][:, :, :, :plen], step_cache["k"][:, :, :, :plen])
    v_err, v_bad = _cache_err(cache["v"][:, :, :, :plen], step_cache["v"][:, :, :, :plen])
    out = {
        "phase": "serve_parity", "sizes": SERVE_SIZES, "dtype": "bfloat16",
        "atol": SERVE_ATOL, "cache_rtol": SERVE_CACHE_RTOL,
        "prefill_vs_stepwise": {
            "logits_max_abs_err": logit_err, "k_max_abs_err": k_err, "v_max_abs_err": v_err,
            "cache_out_of_tol": k_bad + v_bad,
            "logits_shape": list(logits.shape),
            "argmax_agree": float((logits.argmax(-1) == step_logits.argmax(-1)).float().mean()),
        },
    }
    if (
        logit_err > SERVE_ATOL or k_bad or v_bad
        or not bool(torch.isfinite(logits).all())
        or list(logits.shape) != [gen.batch, cfg.vocab]
    ):
        raise AssertionError(f"prefill disagrees with stepwise decode: {out}")
    runs = {}
    for mode, use_graph in (("eager", False), ("graph", True)):
        gen.reset_state()
        gen.run_burst(use_graph=use_graph)
        tokens, burst_cache, pos = gen.state()
        runs[mode] = (tokens.clone(), {n: t.clone() for n, t in burst_cache.items()}, pos)
    (et, ec, ep), (gt, gc, gp) = runs["eager"], runs["graph"]
    same = torch.equal(et, gt) and ep == gp and all(torch.equal(ec[n], gc[n]) for n in ec)
    out["graph_vs_eager"] = {
        "bit_identical": same, "pos": gp, "tokens": gt.tolist(),
        "cache_max_abs_diff": max(float((ec[n].float() - gc[n].float()).abs().max()) for n in ec),
    }
    emit(out)
    if not same:
        raise AssertionError(f"the graph burst differs from the eager burst: {out['graph_vs_eager']}")
    return out


def phase_serve_loadgen(gen: DecodeLoadGen) -> dict:
    t0 = time.perf_counter()
    gen.run_burst(use_graph=False)
    eager_ms = (time.perf_counter() - t0) * 1e3
    bursts = 20
    t0 = time.perf_counter()
    for _ in range(bursts):
        gen.run_burst()
    graph_ms = (time.perf_counter() - t0) * 1e3 / bursts
    saturated, headroom = measure_saturated_signal(gen)
    stats = gen.stats()
    out = {
        "phase": "serve_loadgen", "sizes": SERVE_SIZES,
        "tokens_per_burst": gen.tokens_per_burst, "window_s": gen.window,
        "burst_ms_graph": graph_ms, "burst_ms_eager": eager_ms,
        "bytes_per_burst": gen.bytes_per_burst(),
        "device_gbps_at_graph_burst": gen.bytes_per_burst() / graph_ms / 1e6,
        "tokens_per_s": stats.tokens_per_sec,
        "prefill_tokens_per_s": stats.prefill_tokens_per_sec,
        "achieved_gbps": stats.achieved_gbps, "hbm_bw_util_pct": stats.hbm_bw_util_pct,
        "peak_hbm_gbps": gen.peak_hbm_gbps,
        "saturated_signal_pct": saturated, "target_pct": SERVE_BW_TARGET,
        "headroom": headroom, "flash_launches_per_burst": gen.flash_launches_per_burst,
    }
    emit(out)
    if gen.flash_launches_per_burst != gen.cfg.n_layers:
        raise AssertionError(f"the captured burst holds {gen.flash_launches_per_burst} flash launches")
    return out


def phase_serve_profile(gen: DecodeLoadGen) -> dict:
    """One graph burst under torch.profiler (``_after_lead``): device
    time by kernel, and the device's idle share of the burst's host wall
    time (profiled, so an upper bound).  The burst must hold one flash
    launch a layer."""
    gen.run_burst()
    torch.cuda.synchronize()
    kernels, wall_ms = _after_lead(gen.run_burst)
    flash = {name: k for name, k in kernels.items() if "flash_fwd_kernel" in name}
    busy_ms = sum(k["ms"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12])
    out = {
        "phase": "serve_profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_names": len(kernels), "kernel_calls": sum(k["calls"] for k in kernels.values()),
        "flash": flash, "top_kernels": top,
    }
    emit(out)
    if sum(k["calls"] for k in flash.values()) != gen.cfg.n_layers:
        raise AssertionError(f"the profiled burst ran the flash kernel {flash}, not once per layer")
    return out


def phase_serve_loop(gen: DecodeLoadGen) -> tuple[int, float]:
    """The serve loop on the flash kernel, at time scale 1."""
    flash_attention_kernel.launches = 0
    replays = gen.replays
    t0 = time.perf_counter()
    result = run_serve_trial(gen)
    wall = time.perf_counter() - t0
    launches = (
        flash_attention_kernel.launches
        + (gen.replays - replays) * gen.flash_launches_per_burst
    )
    if launches <= 0:
        raise AssertionError("the serve loop launched the flash kernel no time")
    emit({
        "phase": "serve_loop", "hpa_metric": SERVE_SERIES, "target": SERVE_BW_TARGET,
        "time_scale": 1.0, "saturated_signal_pct": result.saturated_pct,
        "headroom": result.headroom,
        "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": wall,
        "replays": gen.replays - replays, "flash_launches": launches,
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), v] for t, v in result.series],
    })
    return launches, result.scale_up_s


def _grad_err(
    got: torch.Tensor, want: torch.Tensor, atol: float = BWD_ATOL, rel_rms: float = BWD_REL_RMS,
    rtol: float = BWD_RTOL,
) -> dict:
    want = want.float()
    diff = (got.float() - want).abs()
    bad = int((diff > atol + rtol * want.abs()).sum())
    at = int(diff.argmax())
    rms_ratio = float(diff.square().mean().sqrt() / want.square().mean().sqrt())
    finite = bool(torch.isfinite(got.float()).all())
    return {
        "ok": finite and bad == 0 and rms_ratio <= rel_rms,
        "max_abs_err": float(diff.view(-1)[at]), "out_of_tol": bad, "atol": atol, "rtol": rtol,
        "want_at_max_err": float(want.view(-1)[at]),
        "excess_over_rtol": float((diff - rtol * want.abs()).max()),
        "rms_err_over_rms_want": rms_ratio, "rel_rms_bar": rel_rms,
        "rms_want": float(want.square().mean().sqrt()),
        "max_abs_want": float(want.abs().max()), "finite": finite,
    }


def _grads_f64(q, k, v, do, causal: bool) -> tuple[torch.Tensor, ...]:
    """The exact (dQ, dK, dV) of attention at these operands, in f64 from
    the operands' values: no rounding of P, dS or the output between the
    products, delta from the f64 output.  In q's layout, contiguous."""
    qb, kb, vb, dob = (flash_attention._bhsd(t).double() for t in (q, k, v, do))
    s = qb @ kb.transpose(1, 2) / math.sqrt(q.shape[-1])
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = p @ vb
    ds = p * (dob @ vb.transpose(1, 2) - (dob * o).sum(-1, keepdim=True)) / math.sqrt(q.shape[-1])
    return tuple(flash_attention._bshd_like(g, q)
                 for g in (ds @ kb, ds.transpose(1, 2) @ qb, p.transpose(1, 2) @ dob))


def _f64_referee(got, want, exact) -> dict:
    """Kernel and plain version each against the exact gradient: the
    largest and the RMS error, at the element where the two sides differ
    most, and ``ok``: the kernel's errors within F64_RATIO of the plain
    version's."""
    kernel, plain = (got.double() - exact).abs(), (want.double() - exact).abs()
    at = int((got.double() - want.double()).abs().argmax())
    out = {"kernel_max_err": float(kernel.max()), "plain_max_err": float(plain.max()),
           "kernel_rms_err": float(kernel.square().mean().sqrt()),
           "plain_rms_err": float(plain.square().mean().sqrt()), "ratio_bar": F64_RATIO,
           "at_max_diff": {"exact": float(exact.view(-1)[at]),
                           "kernel_err": float(kernel.view(-1)[at]),
                           "plain_err": float(plain.view(-1)[at])}}
    out["ok"] = (out["kernel_max_err"] <= F64_RATIO * out["plain_max_err"]
                 and out["kernel_rms_err"] <= F64_RATIO * out["plain_rms_err"])
    return out


def phase_flash_bwd_parity() -> dict[str, dict[str, float]]:
    """The two backward kernels of each dtype against their plain versions,
    then the autograd Function against autograd through the plain forward
    (bf16 at FN_ATOL; f32, where neither side rounds, at the f32 gradient
    bar).  Returns the worst absolute error of each kernel by dtype name,
    and of the chunked instantiations (head_dim 384 and 512) by dtype name
    and ``_wide``, of the streamed ones by dtype name and ``_streamed``, of
    the f32 cluster tiling as ``f32_cluster`` (``_bwd_kind``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {name: {"dq": 0.0, "dkv": 0.0}
             for name in (*DT_NAME.values(), "bf16_wide", "f16_wide", "f32_cluster",
                          *(f"{name}_streamed" for name in DT_NAME.values()))}
    rows = []
    failed = []

    def check(row: dict, names) -> None:
        if not all(row[n]["ok"] for n in names):
            failed.append(row)

    for b, s, h, d, causal, dt in BWD_SHAPES:
        q, k, v = _qkv_views(b, s, h, d, gen, dt)
        o, lse = flash_attention_kernel(q, k, v, causal, with_lse=True)
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
        got = flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        atol, rtol = GRAD_BARS[dt]
        row = {"bshd": [b, s, h, d], "causal": causal, "dtype": DT_NAME[dt]}
        row.update({n: _grad_err(g, w, atol, rtol=rtol)
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)})
        if (b, s, h, d) in BWD_F64_SHAPES:
            row["f64"] = {n: _f64_referee(g, w, x) for n, g, w, x in zip(
                ("dq", "dk", "dv"), got, want, _grads_f64(q, k, v, do, causal))}
            for n, err in row.items():
                if n in row["f64"]:
                    # the bar, or past it the referee (BWD_F64_SHAPES' note)
                    err["held_by"] = "bar" if err["ok"] else "f64"
                    err["ok"] = err["ok"] or (
                        row["f64"][n]["ok"] and err["finite"]
                        and err["rms_err_over_rms_want"] <= err["rel_rms_bar"])
        rows.append(row)
        check(row, ("dq", "dk", "dv"))
        w = worst[_bwd_kind(d, dt)]
        w["dq"] = max(w["dq"], row["dq"]["max_abs_err"])
        w["dkv"] = max(w["dkv"], row["dk"]["max_abs_err"], row["dv"]["max_abs_err"])
    b, s, h, d = LLM_SHAPE
    functions = []
    for dt, bars in ((torch.bfloat16, (FN_ATOL, FN_REL_RMS, BWD_RTOL)),
                     (torch.float32, (GRAD_BARS[torch.float32][0], BWD_REL_RMS,
                                      GRAD_BARS[torch.float32][1]))):
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dt)
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
        grads = {}
        for name, fn in (
            ("function", lambda q, k, v: FlashAttention.apply(q, k, v, True)),
            ("plain_autograd", lambda q, k, v: flash_attention_reference(q, k, v, True)),
        ):
            leaf = qkv.clone().requires_grad_()
            q, k, v = (t.view(b, s, h, d) for t in leaf.split(h * d, dim=-1))
            fn(q, k, v).backward(do)
            grads[name] = leaf.grad
        torch.cuda.synchronize()
        function = {"bshd": list(LLM_SHAPE), "causal": True, "dtype": DT_NAME[dt],
                    "dqkv": _grad_err(grads["function"], grads["plain_autograd"], bars[0],
                                      bars[1], rtol=bars[2])}
        check(function, ("dqkv",))
        functions.append(function)
    refused = {}
    bf16 = torch.bfloat16
    ok = torch.zeros(1, 128, 2, 128, device="cuda", dtype=bf16)
    lse = torch.zeros(2, 128, 1, device="cuda")
    cases = {
        "f64": (ok.double(), lse),
        "seq_100": (ok[:, :100], lse[:, :100]),
        "head_dim_576": (torch.zeros(1, 128, 2, 576, device="cuda", dtype=bf16), lse),
        "f32_head_dim_320": (torch.zeros(1, 128, 2, 320, device="cuda"), lse),
        "stride_not_8": (torch.zeros(1, 128, 2, 132, device="cuda", dtype=bf16)[..., :128], lse),
        "lse_shape": (ok, lse[:1]),
        "lse_bf16": (ok, lse.to(bf16)),
    }
    for case, (t, l) in cases.items():
        try:
            flash_attention_bwd_kernel(t, t, t, t, l, t, True)
        except (TypeError, ValueError) as e:
            refused[case] = type(e).__name__
        else:
            raise AssertionError(f"flash_attention_bwd_kernel took a {case} operand")
    emit({"phase": "flash_bwd_parity",
          "bars": {DT_NAME[dt]: bar for dt, bar in GRAD_BARS.items()},
          "rel_rms": BWD_REL_RMS, "shapes": rows,
          "function_vs_plain_autograd": functions, "refused": refused})
    if failed:
        raise AssertionError(f"flash backward disagrees with its plain version: {failed}")
    return worst


def bwd_work(b: int, s: int, h: int, d: int, causal: bool,
             elem: int = 2) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each backward kernel: per (batch-head, query,
    key) pair at or below the diagonal three products of 2 d operations for
    dQ (S, dP, dS K) and four for dK/dV (S, dP, P^T dO, dS^T Q); Q, K, V and
    dO read once, fp32 lse and delta read once, the gradients written once,
    ``elem`` bytes an element (2: bf16, f16; 4: f32)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    elems, rows = b * s * h * d, b * h * s
    reads = 4 * elems * elem + 2 * rows * 4
    return {"dq": (6.0 * d * pairs, reads + elems * elem),
            "dkv": (8.0 * d * pairs, reads + 2 * elems * elem)}


def _bound(flops: float, nbytes: float, peak_tflops: float, peak_gbps: float) -> dict:
    ms_by_ops = flops / (peak_tflops * 1e12) * 1e3
    ms_by_bytes = nbytes / (peak_gbps * 1e9) * 1e3
    return {"bound_ms": max(ms_by_ops, ms_by_bytes),
            "bound_by": "operations" if ms_by_ops >= ms_by_bytes else "bytes",
            "bound_ops_ms": ms_by_ops, "bound_bytes_ms": ms_by_bytes,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def phase_flash_bwd_timing(peak_gbps: float) -> list[dict]:
    """Each backward kernel's device time by graph replay, in turns (plain,
    kernel, kernel, plain; once each in f16 and f32), beside its bound, its
    plain version and scaled_dot_product_attention's backward: SDPA forward
    plus backward minus SDPA forward, one call that computes dQ, dK and dV
    together.  That call
    is compared whole with the pair (``pair``: dQ ms + dK/dV ms); each
    kernel's ``library_ms`` is the call's time times the kernel's share of
    the pair's operations (6/14 for dQ, 8/14 for dK/dV), so that no row
    reads as one kernel against the whole call.  The training forward (with
    the logsumexp) is timed at the same shapes.  Each row's bound names the
    peak it takes (``_peak``), and SDPA runs in the row's dtype with TF32
    off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for b, s, h, d, dt in BWD_TIMED:
        q, k, v, do = (
            torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
            for _ in range(4)
        )
        peak, named = _peak(dt)
        o, lse = flash_attention_kernel(q, k, v, True, with_lse=True)
        delta = flash_attention_bwd_delta(o, do)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        iters = (50 if s <= 2048 else 10) // (5 if dt == torch.float32 else 1)
        plain_iters = 2

        def sdpa_fwd():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        library_fwd = graph_time_ms(sdpa_fwd, iters)
        library_bwd = graph_time_ms(sdpa_fwd_bwd, iters) - library_fwd
        row = {"bshd": [b, s, h, d], "dtype": DT_NAME[dt], "causal": True, "bound_peak": named,
               "library": "F.scaled_dot_product_attention backward (fwd+bwd minus fwd)",
               "library_backend": _sdpa_backend(qt, kt, vt), "library_fwd_ms": library_fwd}
        plains = {
            "dq": lambda: flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, True),
            "dkv": lambda: flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, True),
        }
        work = bwd_work(b, s, h, d, causal=True, elem=q.element_size())
        pair_flops = sum(flops for flops, _ in work.values())
        for name, (flops, nbytes) in work.items():
            def kernel_call(name=name):
                flash_attention_bwd_launch(name, q, k, v, do, lse, delta, True)

            # in turns (f16 and f32: once each)
            plain = [graph_time_ms(plains[name], plain_iters)]
            kernel = [graph_time_ms(kernel_call, iters)]
            if dt == torch.bfloat16:
                kernel.append(graph_time_ms(kernel_call, iters))
                plain.append(graph_time_ms(plains[name], plain_iters))
            row[name] = {
                "ms": min(kernel), "ms_runs": kernel, "tflops": flops / min(kernel) / 1e9,
                "plain_ms": min(plain), "plain_ms_runs": plain,
                "library_ms": library_bwd * flops / pair_flops,
                "library_share": flops / pair_flops,
                **_bound(flops, nbytes, peak, peak_gbps),
            }
            row[name]["fraction_of_bound"] = row[name]["bound_ms"] / row[name]["ms"]
        pair_ms = row["dq"]["ms"] + row["dkv"]["ms"]
        row["pair"] = {"ms": pair_ms, "library_ms": library_bwd,
                       "over_library": pair_ms / library_bwd}
        fwd_flops, fwd_bytes = flash_work(b, s, h, d, causal=True, elem=q.element_size())
        fwd_ms = graph_time_ms(lambda: flash_attention_kernel(q, k, v, True, with_lse=True), iters)
        row["fwd_with_lse"] = {"ms": fwd_ms, "tflops": fwd_flops / fwd_ms / 1e9,
                               "library_ms": library_fwd,
                               **_bound(fwd_flops, fwd_bytes, peak, peak_gbps)}
        out.append(row)
    emit({"phase": "flash_bwd_timing", "shapes": out})
    return out


def _bwd_counts() -> dict[str, int]:
    return {"fwd": flash_attention_kernel.launches, "dq": flash_attention_bwd_kernel.dq_launches,
            "dkv": flash_attention_bwd_kernel.dkv_launches}


def _zero_counts() -> None:
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.dq_launches = 0
    flash_attention_bwd_kernel.dkv_launches = 0
    for counts in (flash_attention_kernel.launches_by_dtype,
                   flash_attention_bwd_kernel.dq_launches_by_dtype,
                   flash_attention_bwd_kernel.dkv_launches_by_dtype,
                   matmul_kernel.launches_by_dtype):
        counts.update(dict.fromkeys(counts, 0))


def _dtype_counts(dt: torch.dtype) -> dict[str, int]:
    """Every kernel's launches of ``dt`` since the counts were set to 0."""
    name = DT_NAME[dt]
    return {"matmul": matmul_kernel.launches_by_dtype[name],
            "fwd": flash_attention_kernel.launches_by_dtype[name],
            "dq": flash_attention_bwd_kernel.dq_launches_by_dtype[name],
            "dkv": flash_attention_bwd_kernel.dkv_launches_by_dtype[name]}


def _grad_rel(cfg, grads: list[torch.Tensor], want: list[torch.Tensor]) -> dict[str, float]:
    """Leaf by leaf, the norm of ``grads`` less ``want`` over ``want``'s
    norm, wqkv's gradient apart for its Q, K and V columns: dQ reaches the
    first third only, dK and dV the others."""
    names = ["embed", "pos", "out_norm"] + [
        f"blocks[{i}].{leaf}" for i in range(cfg.n_layers)
        for leaf in ("attn_norm", "wqkv", "wo", "mlp_norm", "w1", "w2")
    ]
    rel = {}
    for name, ga, gr in zip(names, grads, want, strict=True):
        parts = zip(("q", "k", "v"), ga.split(cfg.d_model, -1), gr.split(cfg.d_model, -1)) \
            if name.endswith("wqkv") else ((None, ga, gr),)
        for part, a, r in parts:
            a, r = a.float(), r.float()
            rel[f"{name}.{part}" if part else name] = float((a - r).norm() / r.norm())
    return rel


def _auto_against_ring(gens: dict[str, LlmLoadGen], phase: str,
                       loss_atol: float = TRAIN_LOSS_ATOL,
                       grad_rel: float | None = TRAIN_GRAD_REL) -> dict[str, int]:
    """From the same seeded weights and tokens (LlmLoadGen's): the gradients
    of the training loss through the flash kernels (auto) and through the
    plain blocking (ring), leaf by leaf; then one step of each generator.
    Emits ``phase``'s line and raises where they disagree (the loss beyond
    ``loss_atol``, a leaf's gradient beyond ``grad_rel`` of its norm, unless
    ``grad_rel`` is None: read, not held); returns the auto step's
    launches."""
    cfg = gens["auto"].cfg
    grads = {impl: transformer.make_loss_and_grad(cfg, impl)(g.params, g.tokens)[1]
             for impl, g in gens.items()}
    rel = _grad_rel(cfg, grads["auto"], grads["ring"])
    del grads
    before = {n: t.clone() for n, t in enumerate(transformer.param_leaves(gens["auto"].params))}
    _zero_counts()
    gens["auto"].warmup()
    counts = _bwd_counts()
    gens["ring"].warmup()
    losses = {impl: g.stats().last_loss for impl, g in gens.items()}
    worst, bad, moved = 0.0, 0, 0
    leaves = zip(*(transformer.param_leaves(g.params) for g in gens.values()), strict=True)
    for n, (a, r) in enumerate(leaves):
        diff = (a.float() - r.float()).abs()
        worst = max(worst, float(diff.max()))
        bad += int((diff > TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * r.float().abs()).sum())
        moved += int((a != before[n]).sum())
    out = {
        "phase": phase, "cfg": {"batch": gens["auto"].batch, "seq": cfg.max_seq,
                                         "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                                         "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
                                         "dtype": str(cfg.dtype).removeprefix("torch.")},
        "loss": losses, "loss_diff": abs(losses["auto"] - losses["ring"]),
        "loss_atol": loss_atol,
        "grad_rel_err": rel, "grad_rel_err_max": max(rel.values()),
        "grad_rel_bar": grad_rel,
        "param_max_abs_diff": worst, "param_out_of_tol": bad,
        "param_rtol": TRAIN_PARAM_RTOL, "params_moved_by_auto_step": moved,
        "auto_step_launches": counts,
    }
    emit(out)
    want = {"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers, "dkv": cfg.n_layers}
    if not all(math.isfinite(x) for x in losses.values()) or out["loss_diff"] > loss_atol:
        raise AssertionError(f"the auto and ring steps disagree: {out}")
    if grad_rel is not None and not all(x <= grad_rel for x in rel.values()):  # a NaN fails too
        raise AssertionError(f"the auto and ring gradients disagree: {rel}")
    if bad or moved == 0:
        raise AssertionError(f"the updated weights disagree or did not move: {out}")
    if counts != want:
        raise AssertionError(f"one auto step launched {counts}, not {want}")
    return counts


def phase_llm_parity() -> tuple[dict[str, LlmLoadGen], dict[str, int]]:
    """At full width, auto against ring (``_auto_against_ring``).  Returns
    the generators, one step in, and the auto step's launches."""
    gens = {impl: LlmLoadGen(attn_impl=impl, device="cuda:0") for impl in ("auto", "ring")}
    return gens, _auto_against_ring(gens, "llm_parity")


def _plain_flash(q, k, v, causal=False):
    """The prefill's attention on the flash forward's plain version."""
    return flash_attention_reference(q, k, v, causal)


def _counting_reference(calls: list):
    """``flash_attention.reference_attention`` replaced by a version that
    appends its operands' shape to ``calls``; returns the original, which
    the caller puts back."""
    reference = flash_attention.reference_attention

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return reference(*args, **kwargs)

    flash_attention.reference_attention = counted
    return reference


def _wide_path(sizes: dict, phase: str, steps: int, tokens: int | None = None) -> dict[str, int]:
    """The serving and training paths in bf16 at ``sizes`` (the serving
    container's, at a head width past 128), on the flash kernels of that
    head_dim, the dispatcher's fallback (``reference_attention``) counted:
    it must not run.

    Serve: ``DecodeLoadGen`` warmed up (one eager burst, then the capture),
    then one graph burst (a prefill of 512 and 128 greedy tokens, or
    ``tokens``) against
    the same burst run eagerly with the prefill's attention on the plain
    version: the prefill's logits within SERVE_ATOL, the prompt's cache
    within SERVE_ATOL plus SERVE_CACHE_RTOL of its value; the decoded
    tokens, which a near-tie may turn, read beside them.  The forward
    launches once a layer a prefill.  Training: ``LlmLoadGen`` at the same
    width, auto against ring (``_auto_against_ring``: loss within 0.05,
    gradients leaf by leaf within TRAIN_GRAD_REL), then ``steps`` auto
    steps: step ms, tokens/s and exact launches.  Emits ``phase``'s lines;
    returns the launches of each kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fallbacks = []
    reference = _counting_reference(fallbacks)
    try:
        _zero_counts()
        gen = DecodeLoadGen(**sizes, window=3.0, device="cuda:0",
                            **({"tokens_per_burst": tokens} if tokens else {}))
        # an eager burst, the capture's eager burst on its own stream, and the
        # capture: one launch a layer each
        gen.warmup()
        cfg = gen.cfg
        if (flash_attention_kernel.launches != 3 * cfg.n_layers
                or gen.flash_launches_per_burst != cfg.n_layers):
            raise AssertionError(f"the {phase} burst launched {flash_attention_kernel.launches} "
                                 f"forwards, {gen.flash_launches_per_burst} captured")
        plen = gen.prefill_len
        flash, runs = transformer.flash_attention, {}
        for path, attn in (("kernel", flash), ("plain", _plain_flash)):
            transformer.flash_attention = attn
            try:
                logits, _ = transformer.prefill(
                    gen.params, cfg, gen.prompt,
                    transformer.init_kv_cache(cfg, gen.batch, gen.device))
                gen.reset_state()
                t0 = time.perf_counter()
                gen.run_burst(use_graph=path == "kernel")  # the graph holds the kernel path
                burst_ms = (time.perf_counter() - t0) * 1e3
            finally:
                transformer.flash_attention = flash
            tokens, cache, pos = gen.state()
            runs[path] = (logits, tokens.clone(), {n: c.clone() for n, c in cache.items()}, pos,
                          burst_ms)
        (kl, kt, kc, kp, kernel_ms), (pl, pt, pc, pp, plain_ms) = runs["kernel"], runs["plain"]
        k_err, k_bad = _cache_err(kc["k"][:, :, :, :plen], pc["k"][:, :, :, :plen])
        v_err, v_bad = _cache_err(kc["v"][:, :, :, :plen], pc["v"][:, :, :, :plen])
        serve = {
            "sizes": sizes, "head_dim": cfg.head_dim, "dtype": "bfloat16",
            "atol": SERVE_ATOL, "cache_rtol": SERVE_CACHE_RTOL,
            "logits_max_abs_err": float((kl - pl).abs().max()),
            "argmax_agree": float((kl.argmax(-1) == pl.argmax(-1)).float().mean()),
            "prompt_cache_max_abs_err": max(k_err, v_err), "cache_out_of_tol": k_bad + v_bad,
            "pos": [kp, pp], "tokens_agree": float((kt == pt).float().mean()),
            "graph_burst_ms": kernel_ms, "plain_eager_burst_ms": plain_ms,
            "flash_launches_per_burst": gen.flash_launches_per_burst,
            "finite": bool(torch.isfinite(kl).all())
                      and all(bool(torch.isfinite(c.float()).all()) for c in kc.values()),
        }
        launches = {"fwd": flash_attention_kernel.launches
                    + gen.replays * gen.flash_launches_per_burst, "dq": 0, "dkv": 0}
        del gen, runs, kc, pc
        torch.cuda.empty_cache()
        if (serve["logits_max_abs_err"] > SERVE_ATOL or serve["cache_out_of_tol"]
                or not serve["finite"] or kp != pp):
            emit({"phase": phase, "serve": serve})
            raise AssertionError(f"the {phase} burst disagrees with the plain path: {serve}")
        width = {key: sizes[key] for key in ("d_model", "n_heads", "n_layers")}
        gens = {impl: LlmLoadGen(**width, attn_impl=impl, device="cuda:0")
                for impl in ("auto", "ring")}
        parity = _auto_against_ring(gens, f"{phase}_llm_parity")
        del gens["ring"]
        torch.cuda.empty_cache()
        llm = gens["auto"]
        _zero_counts()
        ms = [llm.step() * 1e3 for _ in range(steps)]
        counts = _bwd_counts()
    finally:
        flash_attention.reference_attention = reference
    n = llm.cfg.n_layers
    want = {"fwd": 2 * n * steps, "dq": n * steps, "dkv": n * steps}
    stats = llm.stats()
    out = {"phase": phase, "serve": serve,
           "llm": {"cfg": {**width, "seq": llm.cfg.max_seq, "batch": llm.batch,
                           "head_dim": llm.cfg.head_dim},
                   "parity_step_launches": parity, "steps": steps, "step_ms": ms,
                   "tokens_per_s": stats.tokens_per_sec, "last_loss": stats.last_loss,
                   "launches": counts},
           "reference_attention_calls": len(fallbacks)}
    emit(out)
    if counts != want or not math.isfinite(stats.last_loss):
        raise AssertionError(f"{steps} {phase} auto steps launched {counts}, not {want}")
    if fallbacks:
        raise AssertionError(f"the {phase} paths fell back to reference_attention: {fallbacks}")
    for name in launches:
        launches[name] += parity[name] + counts[name]
    return launches


def phase_head256() -> dict[str, int]:
    """The serving and training paths at head_dim 256 (HEAD256_SIZES), on
    the d256 instantiations of the three flash kernels (``_wide_path``, with
    HEAD256_STEPS auto steps).  Returns the phase's launches of each
    kernel."""
    return _wide_path(HEAD256_SIZES, "head256", HEAD256_STEPS)


def _serve_in_dtype(sizes: dict, dt: torch.dtype, phase: str) -> dict:
    """``DecodeLoadGen`` at ``sizes`` in ``dt`` with bursts of DTYPE_TOKENS
    tokens, every count set to 0 just before and read just after: the
    warm-up (an eager burst, the capture's eager burst and the capture) and
    one graph replay, one forward a layer each; then the prefill's logits
    against the same prefill on the plain attention, within
    DTYPE_SERVE_ATOL.  Returns the row, ``fwd_launches`` the forward's
    launches; emits ``phase``'s line and raises where it fails."""
    _zero_counts()
    serve = DecodeLoadGen(**sizes, dtype=dt, tokens_per_burst=DTYPE_TOKENS, window=3.0,
                          device="cuda:0")
    serve.warmup()
    serve.run_burst()
    counts = _dtype_counts(dt)
    cfg = serve.cfg
    logits = {}
    flash = transformer.flash_attention
    for path, attn in (("kernel", flash), ("plain", _plain_flash)):
        transformer.flash_attention = attn
        try:
            logits[path], _ = transformer.prefill(
                serve.params, cfg, serve.prompt,
                transformer.init_kv_cache(cfg, serve.batch, serve.device))
        finally:
            transformer.flash_attention = flash
    row = {
        "sizes": sizes, "tokens_per_burst": DTYPE_TOKENS,
        "warmup_launches": counts["fwd"], "replays": serve.replays,
        "flash_launches_per_burst": serve.flash_launches_per_burst,
        "fwd_launches": counts["fwd"] + serve.replays * serve.flash_launches_per_burst,
        "logits_max_abs_err": float((logits["kernel"] - logits["plain"]).abs().max()),
        "logits_atol": DTYPE_SERVE_ATOL[dt],
        "finite": bool(torch.isfinite(logits["kernel"]).all()),
    }
    del serve, logits
    torch.cuda.empty_cache()
    if (counts["fwd"] != 3 * cfg.n_layers or row["flash_launches_per_burst"] != cfg.n_layers
            or row["logits_max_abs_err"] > DTYPE_SERVE_ATOL[dt] or not row["finite"]):
        emit({"phase": phase, "dtype": DT_NAME[dt], "serve": row})
        raise AssertionError(f"the {phase} {DT_NAME[dt]} serve path: {row}")
    return row


def _wide_in_dtype(sizes: dict, phase: str, dt: torch.dtype, steps: int) -> dict[str, int]:
    """The serving and training paths at ``sizes`` in ``dt`` (f16 or f32),
    on that library's instantiations of the head_dim: the serve burst
    (``_serve_in_dtype``); then, every count set to 0 just before and read
    just after, ``steps`` auto steps of ``LlmLoadGen`` at that width, two
    forwards, one dQ and one dK/dV a layer a step, the loss finite.  Returns
    the dtype's launches."""
    row = {"serve": _serve_in_dtype(sizes, dt, phase)}
    launches = {"fwd": row["serve"]["fwd_launches"]}
    n = sizes["n_layers"]
    llm = LlmLoadGen(d_model=sizes["d_model"], n_heads=sizes["n_heads"], n_layers=n, dtype=dt,
                     device="cuda:0")
    _zero_counts()
    ms = [llm.step() * 1e3 for _ in range(steps)]
    counts = _dtype_counts(dt)
    want = {"fwd": 2 * n * steps, "dq": n * steps, "dkv": n * steps}
    got = {key: counts[key] for key in want}
    row["llm"] = {"cfg": {**{key: sizes[key] for key in ("d_model", "n_heads", "n_layers")},
                          "head_dim": llm.cfg.head_dim},
                  "steps": steps, "step_ms": ms, "last_loss": llm.stats().last_loss,
                  "launches": got}
    del llm
    emit({"phase": phase, "dtype": DT_NAME[dt], **row})
    if got != want or not math.isfinite(row["llm"]["last_loss"]):
        raise AssertionError(f"{steps} {phase} auto steps launched {got}, not {want}")
    launches["fwd"] += got["fwd"]
    launches.update(dq=got["dq"], dkv=got["dkv"])
    return launches


def phase_head_wide() -> dict[str, dict[str, int]]:
    """The serving and training paths at head_dim 512 and 384 (WIDE_SIZES:
    D_MODEL=2048 and 1536 in N_HEADS=4), on the chunked instantiations of
    the three flash kernels: in bf16 as ``phase_head256`` runs them
    (``_wide_path``, WIDE_STEPS auto steps), then in f16
    (``_wide_in_dtype``, WIDE_F16_STEPS auto steps),
    the dispatcher's fallback counted in both and never taken.  Returns
    each dtype's launches of each kernel, both widths together."""
    launches = {"bf16": dict.fromkeys(("fwd", "dq", "dkv"), 0),
                "f16": dict.fromkeys(("fwd", "dq", "dkv"), 0)}
    fallbacks = []
    for d, sizes in WIDE_SIZES.items():
        for name, got in _wide_path(sizes, f"head{d}", WIDE_STEPS).items():
            launches["bf16"][name] += got
        torch.cuda.empty_cache()
        reference = _counting_reference(fallbacks)
        try:
            f16 = _wide_in_dtype(sizes, f"head{d}_f16", torch.float16, WIDE_F16_STEPS)
        finally:
            flash_attention.reference_attention = reference
        for name, got in f16.items():
            launches["f16"][name] += got
        torch.cuda.empty_cache()
    emit({"phase": "head_wide", "launches": launches, "reference_attention_calls": len(fallbacks)})
    if fallbacks:
        raise AssertionError(f"the f16 wide paths fell back to reference_attention: {fallbacks}")
    return launches


def phase_head1024() -> dict[str, dict[str, int]]:
    """The serving and training paths on the streamed instantiations of the
    three flash kernels: at head_dim 1024 (STREAMED_SIZES: D_MODEL=2048
    N_HEADS=2) in bf16 as the wide phases run them (``_wide_path``, with
    bursts of STREAMED_TOKENS tokens and STREAMED_STEPS auto steps) and in
    f16 (``_wide_in_dtype``), then at head_dim 512 in f32 (WIDE_SIZES[512]:
    D_MODEL=2048 N_HEADS=4, ``_wide_in_dtype``; the backward there on its
    clusters of four CTAs), with exact launches and the
    dispatcher's fallback (``reference_attention``) counted in each and
    never taken.  Returns each dtype's launches of each kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {"bf16": _wide_path(STREAMED_SIZES, "head1024", STREAMED_STEPS, STREAMED_TOKENS)}
    torch.cuda.empty_cache()
    fallbacks = []
    reference = _counting_reference(fallbacks)
    try:
        for dt, sizes, phase in ((torch.float16, STREAMED_SIZES, "head1024_f16"),
                                 (torch.float32, WIDE_SIZES[512], "head512_f32")):
            launches[DT_NAME[dt]] = _wide_in_dtype(sizes, phase, dt, STREAMED_STEPS)
            torch.cuda.empty_cache()
    finally:
        flash_attention.reference_attention = reference
    emit({"phase": "head_streamed", "launches": launches,
          "reference_attention_calls": len(fallbacks)})
    if fallbacks:
        raise AssertionError(f"the streamed paths fell back to reference_attention: {fallbacks}")
    return launches


#: the dtypes phase's bars by dtype: the training loss, auto against ring
#: (f16 at the bf16 bar, the JAX package's 0.05; f32 at 1e-3), and in f32,
#: where neither path rounds a product, each leaf's gradient against ring's
#: at 1e-3 of its norm.  f16's gradients are read, not held: at init
#: attention is near uniform over 2048 keys (P ~ 5e-4) and dS = P (dP -
#: delta) / sqrt(d) lies near and under f16's smallest subnormal (6e-8), so
#: dS rounded to f16, as the JAX package's kernel rounds it (`.to(q.dtype)`),
#: is mostly 0 or one subnormal step, where the ring keeps it; dQ and dK,
#: and every leaf upstream of them, then differ from ring's, and from the
#: same gradient through the kernels' plain versions wherever a sum's order
#: moves a rounding across one of those coarse steps (both read beside the
#: loss).  The f16 backward kernels are held at their own parity rows, on
#: inputs whose dS is normal.  And the serve prefill's logits on the kernel
#: against the same prefill on its plain attention (f16 at the serve bar,
#: 0.06; f32 at the forward's f32 bar)
DTYPE_LOSS_ATOL = {torch.float16: TRAIN_LOSS_ATOL, torch.float32: 1e-3}
DTYPE_GRAD_REL = {torch.float16: None, torch.float32: 1e-3}
DTYPE_SERVE_ATOL = {torch.float16: SERVE_ATOL, torch.float32: 2e-3}
#: the depth of the dtypes phase's runs: products a headline burst and
#: bursts after the warm-up; tokens a serve burst (after its prefill of 512);
#: auto training steps after the parity step
DTYPE_ITERS, DTYPE_BURSTS, DTYPE_TOKENS, DTYPE_STEPS = 16, 3, 16, 3


def phase_dtypes() -> dict[str, dict[str, int]]:
    """The three load generators in f16 and f32 at full width, on the
    kernels of those dtypes, each with every count set to 0 just before it
    and read just after; the dispatcher's fallback, ``reference_attention``,
    is counted too and must not run.

    Headline: ``MatmulLoadGen(size=4096, dtype, use_kernel=True)``, its
    warm-up burst and DTYPE_BURSTS more of DTYPE_ITERS products: one GEMM a
    product; then one of its products against the plain version at the
    GEMM's bar of the dtype.  Serve: ``DecodeLoadGen`` at the serve cell's
    sizes (SERVE_SIZES: a prefill of 512 on the flash forward) with bursts
    of DTYPE_TOKENS tokens: the warm-up (an eager burst, the capture's
    eager burst and the capture) and one graph replay, one forward a layer
    each; then the prefill's logits against the same prefill on the plain
    attention.  Training: ``LlmLoadGen`` at the rung's defaults, auto
    against ring from the same weights (``_auto_against_ring``: the loss
    within DTYPE_LOSS_ATOL, each leaf's gradient within DTYPE_GRAD_REL),
    then DTYPE_STEPS auto steps: two forwards, one dQ and one dK/dV a layer
    a step.  Returns each dtype's launches of each kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fallbacks = []
    reference = _counting_reference(fallbacks)
    out = {"phase": "dtypes"}
    launches = {}
    try:
        for dt in NEW_DTYPES:
            name = DT_NAME[dt]
            row = {}
            _zero_counts()
            gen = MatmulLoadGen(size=SIZE, dtype=dt, use_kernel=True, iters_per_burst=DTYPE_ITERS,
                                intensity=1.0, window=3.0, device="cuda:0")
            with tempfile.TemporaryDirectory() as knob_dir:
                gen.intensity_file = str(Path(knob_dir) / "intensity")  # absent: API knob only
                gen.warmup()
                for _ in range(DTYPE_BURSTS):
                    gen.step()
            probe = gen._burst(1)
            counts = _dtype_counts(dt)
            a, b = gen._a[0], gen._b[0]
            got, want = matmul_kernel(a, b), matmul_reference(a, b)
            atol, rtol = GEMM_BARS[dt]
            diff = (got.float() - want.float()).abs()
            row["headline"] = {
                "size": SIZE, "products": DTYPE_ITERS * (1 + DTYPE_BURSTS) + 1,
                "launches": counts["matmul"], "probe": probe,
                "max_abs_err": float(diff.max()),
                "out_of_tol": int((diff > atol + rtol * want.float().abs()).sum()),
                "tflops": gen.stats().achieved_tflops,
            }
            launches[name] = {"matmul": counts["matmul"]}
            del gen, a, b, got, want, diff
            if (row["headline"]["launches"] != row["headline"]["products"]
                    or row["headline"]["out_of_tol"] or not math.isfinite(probe)):
                emit({**out, name: row})
                raise AssertionError(f"the {name} headline load: {row['headline']}")

            row["serve"] = _serve_in_dtype(SERVE_SIZES, dt, "dtypes")
            serve_fwd = row["serve"]["fwd_launches"]

            gens = {impl: LlmLoadGen(dtype=dt, attn_impl=impl, device="cuda:0")
                    for impl in ("auto", "ring")}
            if DTYPE_GRAD_REL[dt] is None:
                # the auto gradient through the kernels against the same
                # through their plain versions, which round as they do: read
                auto = gens["auto"]
                loss_and_grad = transformer.make_loss_and_grad(auto.cfg, "auto")
                kernels = loss_and_grad(auto.params, auto.tokens)[1]
                fwd = flash_attention.flash_attention_kernel
                bwd = flash_attention.flash_attention_bwd_kernel
                flash_attention.flash_attention_kernel = flash_attention_reference
                flash_attention.flash_attention_bwd_kernel = flash_attention_bwd_reference
                try:
                    plain = loss_and_grad(auto.params, auto.tokens)[1]
                finally:
                    flash_attention.flash_attention_kernel = fwd
                    flash_attention.flash_attention_bwd_kernel = bwd
                rel = _grad_rel(auto.cfg, kernels, plain)
                del kernels, plain
                row["llm_grads_against_plain_versions"] = {
                    "grad_rel_err": rel, "grad_rel_err_max": max(rel.values())}
            parity = _auto_against_ring(gens, f"dtypes_llm_parity_{name}",
                                        DTYPE_LOSS_ATOL[dt], DTYPE_GRAD_REL[dt])
            del gens["ring"]
            llm = gens.pop("auto")
            _zero_counts()
            ms = [llm.step() * 1e3 for _ in range(DTYPE_STEPS)]
            counts = _dtype_counts(dt)
            n = llm.cfg.n_layers
            want_counts = {"fwd": 2 * n * DTYPE_STEPS, "dq": n * DTYPE_STEPS,
                           "dkv": n * DTYPE_STEPS}
            stats = llm.stats()
            row["llm"] = {"cfg": {"seq": llm.cfg.max_seq, "batch": llm.batch,
                                  "d_model": llm.cfg.d_model, "n_heads": llm.cfg.n_heads,
                                  "n_layers": n},
                          "parity_step_launches": parity, "steps": DTYPE_STEPS,
                          "step_ms": ms, "tokens_per_s": stats.tokens_per_sec,
                          "last_loss": stats.last_loss,
                          "launches": {key: counts[key] for key in want_counts}}
            for key in want_counts:
                launches[name][key] = counts[key] + parity[key]
            launches[name]["fwd"] += serve_fwd
            del llm
            torch.cuda.empty_cache()
            if ({key: counts[key] for key in want_counts} != want_counts
                    or not math.isfinite(stats.last_loss)):
                emit({**out, name: row})
                raise AssertionError(f"{DTYPE_STEPS} {name} auto steps launched {counts}, "
                                     f"not {want_counts}")
            out[name] = row
    finally:
        flash_attention.reference_attention = reference
    out["reference_attention_calls"] = len(fallbacks)
    out["launches"] = launches
    emit(out)
    if fallbacks:
        raise AssertionError(f"the dispatcher fell back to reference_attention: {fallbacks}")
    return launches


def phase_llm_train(gens: dict[str, LlmLoadGen], seconds: float = 3.0) -> dict[str, int]:
    """Each generator steps for ``seconds`` and at least twenty steps: step
    times, tokens/s and the losses.  Returns the auto run's launches."""
    out = {"phase": "llm_train"}
    counts = {}
    for impl, gen in gens.items():
        if impl == "auto":
            _zero_counts()
        ms, losses = [], []
        t0 = time.perf_counter()
        while len(ms) < 20 or time.perf_counter() - t0 < seconds:
            ms.append(gen.step() * 1e3)
            losses.append(gen.stats().last_loss)
        if impl == "auto":
            counts = _bwd_counts()
        stats = gen.stats()
        out[impl] = {
            "steps": len(ms), "step_ms_median": sorted(ms)[len(ms) // 2], "step_ms_min": min(ms),
            "tokens_per_s": stats.tokens_per_sec, "context_length": stats.context_length,
            "losses": losses,
        }
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"the {impl} run's loss went non-finite: {losses}")
    n_layers, steps = gens["auto"].cfg.n_layers, out["auto"]["steps"]
    out["auto"]["launches"] = counts
    out["auto_tokens_per_s_over_ring"] = out["auto"]["tokens_per_s"] / out["ring"]["tokens_per_s"]
    emit(out)
    want = {"fwd": 2 * n_layers * steps, "dq": n_layers * steps, "dkv": n_layers * steps}
    if counts != want:
        raise AssertionError(f"{steps} auto steps launched {counts}, not {want}")
    return counts


def phase_llm_profile(gen: LlmLoadGen) -> dict:
    """One auto step under torch.profiler (``_after_lead``): device time by
    kernel, the launches of the step, and the device's idle share of the
    step's host wall time (profiled, so an upper bound)."""
    gen.step()
    torch.cuda.synchronize()
    kernels, wall_ms = _after_lead(gen.step, before=_zero_counts)
    wrapper = _bwd_counts()
    busy_ms = sum(k["ms"] for k in kernels.values())

    def calls_of(name: str) -> int:
        return sum(k["calls"] for key, k in kernels.items() if name in key)

    flash = {key: k for key, k in kernels.items() if "flash_" in key}
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:16])
    # device time by kind: the flash kernels, cuBLAS's products, copies and
    # casts, and everything else (elementwise, reductions, the update)
    kinds = {"flash": ("flash_",), "products": ("nvjet", "gemm", "xmma"), "copies": ("copy",)}
    by_kind = {kind: {"ms": 0.0, "calls": 0} for kind in (*kinds, "other")}
    for key, k in kernels.items():
        kind = next((n for n, marks in kinds.items() if any(m in key for m in marks)), "other")
        by_kind[kind]["ms"] += k["ms"]
        by_kind[kind]["calls"] += k["calls"]
    out = {
        "phase": "llm_profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_names": len(kernels), "kernel_calls": sum(k["calls"] for k in kernels.values()),
        "by_kind": by_kind, "flash": flash, "top_kernels": top, "wrapper_launches": wrapper,
    }
    emit(out)
    n = gen.cfg.n_layers
    traced = {name: calls_of(f"flash_{kind}_kernel") for name, kind in
              (("fwd", "fwd"), ("dq", "bwd_dq"), ("dkv", "bwd_dkv"))}
    if wrapper != {"fwd": 2 * n, "dq": n, "dkv": n}:
        raise AssertionError(f"the profiled step launched the flash kernels {wrapper}")
    if traced != wrapper:
        raise AssertionError(f"the trace lost kernels: it shows {traced} of the wrappers' "
                             f"launches {wrapper}")
    return out


def phase_llm_entry(work_dir: str, seconds: float = 5.0) -> dict:
    """The rung's container command, ``python -m
    k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with WORKLOAD=llm at its
    defaults and CHECKPOINT_DIR (CHECKPOINT_EVERY 200), for ``seconds``
    after its banner, then SIGTERM: it must exit 0 having reported steps at
    the full context and a finite loss; started again it resumes from its
    last save's step.  Five seconds hold some 150 steps and two reports: the
    script's time goes to the later phases (the whole run must end within 1200 s)."""
    ckpt_dir = str(Path(work_dir) / "llm-ckpt")
    env = dict(os.environ, WORKLOAD="llm", REPORT_S="2", CHECKPOINT_DIR=ckpt_dir,
               CHECKPOINT_EVERY="200", TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    module = "k8s_gpu_hpa_tpu_torch.loadgen.multihost"
    entry = _Entry(module, env)
    try:
        banner = entry.wait_for("tpu-test multihost")
        time.sleep(seconds)
        entry.wait_for("steps=")  # a card shared with train_entry can be slower
    finally:
        code = entry.stop()
    report_lines = [ln for ln in entry.lines if ln.startswith("steps=")]
    reports = [dict(f.split("=", 1) for f in ln.split()) for ln in report_lines]
    out = {"phase": "llm_entry", "exit_code": code, "run_s": seconds, "banner": banner,
           "reports": report_lines,
           "final": [ln for ln in entry.lines if ln.startswith("final checkpoint")]}
    last = reports[-1] if reports else {}
    if (
        code != 0 or not reports or last.get("ctx") != "2048"
        or int(last.get("steps", "0")) <= 0 or not math.isfinite(float(last.get("loss", "nan")))
    ):
        emit(out)
        raise AssertionError(f"the llm entry point did not train as expected: {entry.lines[-20:]}")
    out["restart"] = _resume(module, env, ckpt_dir, entry)
    emit(out)
    return out



# The training rung at the shipped tpu-train sizes (deploy/tpu-train-deployment.yaml:
# ResNet-50 with the CIFAR stem, BATCH_SIZE 256, IMAGE_SIZE 32).  Its convolutions
# are cuDNN's, its BatchNorm PyTorch's own kernels and its head cuBLAS's, as XLA's
# are in the JAX package: no Pallas kernel backs the path, so no hand-written
# kernel runs on it.
TRAIN_BATCH = 256
TRAIN_IMAGE = 32
#: train_parity's batch: the step on the card in bf16 against the same step on
#: the CPU in f32.  At 16 images stage 3's BatchNorms normalise over 256 values
#: a channel, where bf16's roundings stay well inside the bar
TRAIN_PARITY_BATCH = 16
#: the port's bf16 bar, on the loss and on the logits, relative to their RMS
TRAIN_BF16_REL = 0.06
#: the batch statistics a running buffer's move implies, (ra' - 0.9 ra) / 0.1,
#: against the layer input's mean and biased variance, relative to their
#: largest: the unbiased variance differs by 1/255 at stage 3 (n = 256)
TRAIN_STATS_REL = 1e-3
TRAIN_KNOB = 0.25
TRAIN_KNOB_POINTS = 7.5
#: kernels of one training step a trace must hold, by name mark: each
#: BatchNorm's four (statistics and normalisation forward, reduction and
#: input gradient backward; PyTorch's channels_last kernels on the card), and
#: the batch draw's two (images and labels), the step's first kernels
TRAIN_BN_KERNELS = 4
TRAIN_DRAW_KERNELS = 2


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def phase_train_parity() -> dict:
    """One training step of the port at full width on the card (bf16,
    channels_last) against the same step on the CPU in f32, from the same
    seeded weights and the same batch: the train-mode logits and the step's
    loss within 0.06 of their RMS.  And the running statistics of a stage-3
    BatchNorm after one training forward against flax's update from that
    layer's input, ``0.9 ra + 0.1 batch`` with the biased variance."""
    gen = TrainLoadGen(batch_size=TRAIN_PARITY_BATCH, image_size=TRAIN_IMAGE, device="cuda:0")
    ref = TrainLoadGen(batch_size=TRAIN_PARITY_BATCH, image_size=TRAIN_IMAGE,
                       dtype=torch.float32, device="cpu")
    ref.model.load_state_dict(gen.model.state_dict())
    images, labels = gen.batch()
    bn = gen.model.stage3_block2.bn2
    seen = {}
    hook = bn.register_forward_pre_hook(lambda m, args: seen.update(x=args[0].detach().clone()))
    before = (bn.running_mean.clone(), bn.running_var.clone())
    with torch.no_grad():
        logits = gen.model(images, train=True)
        want_logits = ref.model(images.cpu(), train=True)
    hook.remove()
    var, mean = torch.var_mean(seen["x"].float(), (0, 2, 3), correction=0)
    n = seen["x"][:, 0].numel()

    def implied_err(running, ra, want):
        implied = (running - 0.9 * ra) / 0.1
        return float((implied - want).abs().max() / want.abs().max())

    stats_err = {"running_mean": implied_err(bn.running_mean, before[0], mean),
                 "running_var": implied_err(bn.running_var, before[1], var)}
    unbiased_err = implied_err(bn.running_var, before[1], var * n / (n - 1))
    loss = float(gen.train_step(images, labels))
    want_loss = float(ref.train_step(images.cpu(), labels.cpu()))
    out = {
        "phase": "train_parity", "model": "resnet50 cifar_stem", "batch": TRAIN_PARITY_BATCH,
        "image": TRAIN_IMAGE, "dtype": "bfloat16 against float32 on the CPU",
        "activations_channels_last": seen["x"].is_contiguous(memory_format=torch.channels_last),
        "logits_rel_rms": _rel_rms(logits.float().cpu(), want_logits),
        "loss": loss, "loss_cpu_f32": want_loss, "loss_rel": abs(loss - want_loss) / abs(want_loss),
        "bar": TRAIN_BF16_REL, "stage3_bn_stats_rel_err": stats_err,
        "stage3_bn_values_a_channel": n,
        "stage3_bn_var_if_unbiased_rel_err": unbiased_err, "stats_bar": TRAIN_STATS_REL,
    }
    emit(out)
    if not out["logits_rel_rms"] <= TRAIN_BF16_REL or not out["loss_rel"] <= TRAIN_BF16_REL:
        raise AssertionError(f"the step on the card disagrees with the f32 step: {out}")
    if not all(e <= TRAIN_STATS_REL for e in stats_err.values()):
        raise AssertionError(f"the running statistics did not move as flax's do: {out}")
    if not out["activations_channels_last"]:
        raise AssertionError("the activations are not channels_last on the card")
    return out


def phase_train_loadgen() -> tuple[TrainLoadGen, dict]:
    """TrainLoadGen at the shipped sizes: step time (median), images/s and
    the peak memory over some twenty steps at full duty; then the
    container's knob at 0.25, whose 3 s windowed duty cycle must read 0.25."""
    gen = TrainLoadGen(batch_size=TRAIN_BATCH, image_size=TRAIN_IMAGE, device="cuda:0")
    gen.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    t0 = time.perf_counter()
    while len(ms) < 20 or time.perf_counter() - t0 < 3.0:
        ms.append(gen.step() * 1e3)
    images_per_s = len(ms) * TRAIN_BATCH / (sum(ms) / 1e3)
    peak = torch.cuda.max_memory_allocated()
    knob = IntensityKnob(TRAIN_KNOB)
    duty = WindowedDuty(3.0)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 7.0:
        t_iter = time.perf_counter()
        busy = gen.step()
        duty.record(time.perf_counter() - t_iter)
        knob.throttle(busy)
    out = {
        "phase": "train_loadgen", "model": "resnet50 cifar_stem", "batch": TRAIN_BATCH,
        "image": TRAIN_IMAGE, "dtype": "bfloat16", "steps": len(ms),
        "step_ms_median": sorted(ms)[len(ms) // 2], "step_ms_min": min(ms),
        "images_per_s": images_per_s, "peak_memory_gib": peak / 2**30,
        "last_loss": gen.stats().last_loss,
        "knob": TRAIN_KNOB, "duty_at_knob_pct": duty.value(),
    }
    emit(out)
    if not math.isfinite(out["last_loss"]):
        raise AssertionError(f"the training loss went non-finite: {out}")
    if abs(out["duty_at_knob_pct"] - 100.0 * TRAIN_KNOB) > TRAIN_KNOB_POINTS:
        raise AssertionError(f"the duty cycle does not track the knob: {out}")
    return gen, out


#: device time by kind in train_profile, by kernel-name marks (cuDNN's
#: convolution kernels; BatchNorm's; the SGD update's foreach kernels;
#: copies, casts and memsets); the rest is elementwise work and reductions
TRAIN_KINDS = {  # the first kind whose marks a name holds
    "batchnorm": ("batch_norm", "batchnorm", "bn_", "welford"),
    "sgd": ("multi_tensor_apply", "foreach"),
    "copies": ("copy", "Memcpy", "Memset", "cast"),
    "convolution": ("conv", "xmma", "implicit_gemm", "cudnn", "cutlass", "sm90_", "nchw", "nhwc",
                    "gemm", "nvjet"),
}


def _profile_train_step(gen: TrainLoadGen) -> dict:
    """Trace a lead step and then the measured one, each under a named
    range, and keep the device's kernels inside the measured step's range
    on the device's timeline: a trace that drops kernels at its head (as
    some late in a long run have) drops the lead step's, not these."""
    gen.step()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _warm_trace()
        with torch.profiler.record_function("lead_step"):
            gen.step()
        t0 = time.perf_counter()
        with torch.profiler.record_function("traced_step"):
            gen.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = {e.name: e.time_range for e in on_device
             if e.is_user_annotation and e.name in ("lead_step", "traced_step")}
    kernels, lead_calls = {}, 0
    for e in on_device:
        if e.is_user_annotation or "spin_kernel" in e.name:
            continue
        start = e.time_range.start
        if "lead_step" in spans and spans["lead_step"].start <= start <= spans["lead_step"].end:
            lead_calls += 1
        if "traced_step" in spans and spans["traced_step"].start <= start <= spans["traced_step"].end:
            k = kernels.setdefault(e.name[:100], {"ms": 0.0, "calls": 0})
            k["ms"] += e.time_range.elapsed_us() / 1e3
            k["calls"] += 1
    by_kind = {kind: {"ms": 0.0, "calls": 0} for kind in (*TRAIN_KINDS, "elementwise and other")}
    for key, k in kernels.items():
        kind = next((n for n, marks in TRAIN_KINDS.items()
                     if any(m in key for m in marks)), "elementwise and other")
        by_kind[kind]["ms"] += k["ms"]
        by_kind[kind]["calls"] += k["calls"]
    busy_ms = sum(k["ms"] for k in kernels.values())
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_calls": sum(k["calls"] for k in kernels.values()),
        "lead_step_calls": lead_calls,
        "spin_kernels_seen": sum("spin_kernel" in e.name for e in on_device),
        "by_kind": by_kind,
        "draw_calls": sum(k["calls"] for key, k in kernels.items() if "distribution" in key),
        "top_kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:16]),
    }


def phase_train_profile(gen: TrainLoadGen, attempts: int = 2) -> dict:
    """One step at the shipped sizes under torch.profiler: the kernels it
    launched, device time by kind, and the device's idle share of the
    step's host wall time (profiled, so an upper bound).  The trace must
    hold the step's batch draw, its first two kernels, and four kernels for
    each BatchNorm layer; a trace short of them is traced again, up to
    ``attempts`` times, then fails."""
    n_bn = sum(isinstance(m, BatchNorm) for m in gen.model.modules())
    want = {"batchnorm": TRAIN_BN_KERNELS * n_bn, "draw": TRAIN_DRAW_KERNELS}
    for attempt in range(1, attempts + 1):
        row = _profile_train_step(gen)
        got = {"batchnorm": row["by_kind"]["batchnorm"]["calls"], "draw": row["draw_calls"]}
        if got == want:
            break
    out = {"phase": "train_profile", "batch": TRAIN_BATCH, "attempts": attempt,
           "batchnorm_layers": n_bn, "expected": want, **row}
    emit(out)
    if got != want:
        raise AssertionError(f"the trace lost kernels: it holds {got}, not {want}")
    return out


def phase_train_loop(gen: TrainLoadGen) -> dict:
    """The training loop, as bench.py's training rung runs it: TrainLoad at
    0.15 then 1.0 → TorchDeviceSource (the windowed duty cycle; no bandwidth
    gauge, none is measured on the card) → ExporterDaemon over HTTP →
    Scraper → both tpu-train rules → adapter → the shipped two-metric HPA
    must scale 1 → 4 within the 60 s budget on the duty cycle alone."""
    t0 = time.perf_counter()
    steps0 = gen.stats().steps
    result = run_train_trial(gen)
    out = {
        "phase": "train_loop", "hpa_metrics": [TRAIN_DUTY_SERIES, TRAIN_BW_SERIES],
        "time_scale": 1.0, "scale_up_s": result.scale_up_s, "budget_s": 60.0,
        "spike_to_cross_s": result.spike_to_cross_s, "wall_s": time.perf_counter() - t0,
        "steps": gen.stats().steps - steps0,
        "bw_gauge": "absent: no source on the card measures it",
        "replicas": [list(r) for r in result.replicas],
        "metrics_at_sync": [[round(t, 2), m] for t, m in result.metrics],
        "series": [[round(t, 2), duty, bw] for t, duty, bw in result.series],
    }
    emit(out)
    if any(m[TRAIN_BW_SERIES] is not None for _, m in result.metrics):
        raise AssertionError("the HPA had a bandwidth series no source serves")
    if not all(m[TRAIN_DUTY_SERIES] is not None for _, m in result.metrics):
        raise AssertionError(f"the HPA lacked the duty cycle at a sync: {result.metrics}")
    return out


class _Entry:
    """A container command run as a subprocess from the repository root,
    its output gathered by a thread."""

    def __init__(self, module: str, env: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module], cwd=Path(__file__).resolve().parent, env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self.lines: list[str] = []
        self._reader = threading.Thread(
            target=lambda: self.lines.extend(ln.rstrip() for ln in self.proc.stdout))
        self._reader.start()

    def wait_for(self, prefix: str, seconds: float = 180, count: int = 1) -> str:
        """The last line that starts with ``prefix``, once ``count`` do."""
        deadline = time.monotonic() + seconds
        while True:
            found = [ln for ln in self.lines if ln.startswith(prefix)]
            if len(found) >= count:
                return found[-1]
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"no line {prefix!r}: {self.lines[-20:]}")
            time.sleep(0.2)

    def stop(self) -> int:
        """SIGTERM, then its exit code."""
        self.proc.send_signal(signal.SIGTERM)
        return self.wait()

    def wait(self) -> int:
        """Its exit code, waited for up to 60 s, after which it is killed."""
        try:
            return self.proc.wait(timeout=60)
        finally:
            self.proc.kill()
            self._reader.join(timeout=10)


def _saved_step(entry: _Entry, ckpt_dir: str) -> int:
    """The step of the newest save a SIGTERM'd entry point left: its final
    save's, or a periodic one's where the last step had just been saved."""
    steps = make_checkpoint_manager(ckpt_dir).all_steps()
    final = [ln for ln in entry.lines if ln.startswith("final checkpoint at step ")]
    if not steps or (final and int(final[-1].rsplit(" ", 1)[1]) != steps[-1]):
        raise AssertionError(f"the saves {steps} do not end at the final one: {final}")
    return steps[-1]


def _resume(module: str, env: dict, ckpt_dir: str, first: _Entry) -> dict:
    """Restart a SIGTERM'd entry point on its checkpoint directory: it must
    resume from the step of its last save, step on and exit 0 on SIGTERM."""
    saved = _saved_step(first, ckpt_dir)
    entry = _Entry(module, env)
    try:
        resumed = entry.wait_for("resumed from step ")
        report = entry.wait_for("steps=")
    finally:
        code = entry.stop()
    steps = int(dict(f.split("=", 1) for f in report.split())["steps"])
    out = {"saved_step": saved, "resumed": resumed, "report_after": report, "exit_code": code}
    if resumed != f"resumed from step {saved} in {ckpt_dir}" or steps <= saved or code != 0:
        raise AssertionError(f"the restart did not resume from the last save: {out}")
    return out


def phase_train_entry(work_dir: str, seconds: float = 3.0) -> dict:
    """The tpu-train container command, ``python -m
    k8s_gpu_hpa_tpu_torch.loadgen.train`` at its defaults (ResNet-50,
    batch 256, image 32), with CHECKPOINT_DIR, CHECKPOINT_EVERY 20 and a
    1 s PROFILE_S: it trains and reports, writes its Chrome trace, saves on
    SIGTERM and exits 0; started again it resumes from that save's step.
    The ``seconds`` after its trace hold some 100 steps and a report."""
    ckpt_dir = str(Path(work_dir) / "train-ckpt")
    profile_dir = Path(work_dir) / "train-profile"
    env = dict(os.environ, REPORT_S="2", CHECKPOINT_DIR=ckpt_dir, CHECKPOINT_EVERY="20",
               PROFILE_S="1", PROFILE_DIR=str(profile_dir),
               TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    module = "k8s_gpu_hpa_tpu_torch.loadgen.train"
    first = _Entry(module, env)
    try:
        banner = first.wait_for("tpu-train loadgen")
        first.wait_for("profiling: trace written")
        time.sleep(seconds)
        report = first.wait_for("steps=")
    finally:
        code = first.stop()
    traces = sorted(p.name for p in profile_dir.glob("*.json"))
    out = {"phase": "train_entry", "exit_code": code, "banner": banner, "report": report,
           "final": [ln for ln in first.lines if ln.startswith("final checkpoint")],
           "traces": traces, "trace_bytes": sum(p.stat().st_size for p in profile_dir.glob("*.json"))}
    if code != 0 or traces != [f"trace-{first.proc.pid}.json"]:
        emit(out)
        raise AssertionError(f"the train entry point did not run as expected: {first.lines[-20:]}")
    out["restart"] = _resume(module, env, ckpt_dir, first)
    emit(out)
    loss = float(dict(f.split("=", 1) for f in report.split())["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"the train entry point's loss went non-finite: {report}")
    return out


# The mesh over torch.distributed (parallel/mesh.py) and what runs on it: the
# tensor-parallel MLP (models/tp_mlp.py), the slice container's collective rung
# (loadgen/allreduce.py, WORKLOAD=allreduce) and data-parallel ResNet training
# (loadgen/train.py over a mesh).  NCCL takes one rank a GPU and the card has
# one, so the NCCL group holds one rank; two ranks share the card only over
# gloo, which carries all_reduce and broadcast of CUDA tensors, in train_dp.
# No hand-written kernel is on these paths: the collectives are NCCL's (or
# gloo's), the products cuBLAS's, as XLA's are in the JAX package.
#: the MLP's d_model, d_hidden and batch
TP_SIZES = (512, 2048, 256)
#: its bars against gelu_tanh(x @ w1) @ w2 on the card, same weights: JAX's f32
#: bar (tests/test_jax_workloads.py), and the port's bf16 bar on the RMS
TP_F32_ATOL = 2e-4
TP_BF16_REL = 0.06
#: the collective rung's run, seconds
ALLREDUCE_S = 3.0
#: the data-parallel step on two ranks against one rank's on the whole batch,
#: relative to the RMS of what is compared: the port's bf16 bar
DP_REL = 0.06
#: the seed of train_dp's global batch, whose halves differ in mean
DP_SEED = 11
#: seconds a train_dp rank waits for a rendezvous or a collective
DP_TIMEOUT_S = 120


def _group_of_one(device: str) -> str:
    """A process group of this process alone (NCCL on the card), its
    rendezvous on a free port of 127.0.0.1; its address."""
    topology = HostTopology(0, 1, f"127.0.0.1:{free_port()}")
    initialize(topology, device=device)
    return f"tcp://{topology.coordinator_address}"


def phase_mesh(device: str = "cuda:0"):
    """``make_mesh()`` over a group of one: {"data": 1, "model": 1} on the
    group's backend (NCCL), and a model axis of 2 refused."""
    address = _group_of_one(device)
    mesh = make_mesh()
    try:
        make_mesh(model_parallelism=2)
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    out = {"phase": "mesh", "rendezvous": address, "backend": dist.get_backend(),
           "world": dist.get_world_size(), "mesh": mesh_shape(mesh),
           "device_type": mesh.device_type, "model_parallelism_2": refused}
    emit(out)
    want_backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if (out["mesh"] != {"data": 1, "model": 1} or out["backend"] != want_backend
            or out["device_type"] != torch.device(device).type or refused is None):
        raise AssertionError(f"the mesh is not the one asked for: {out}")
    return mesh


def phase_tp_mlp(mesh, device: str = "cuda:0") -> dict:
    """The tensor-parallel MLP on the mesh of one rank, f32 and bf16, against
    gelu_tanh(x @ w1) @ w2 computed plainly in f32 from the same weights."""
    d_model, d_hidden, batch = TP_SIZES
    out = {"phase": "tp_mlp", "mesh": mesh_shape(mesh), "d_model": d_model,
           "d_hidden": d_hidden, "batch": batch}
    for dtype in (torch.float32, torch.bfloat16):
        params = init_tp_mlp(torch.Generator(device).manual_seed(0), d_model, d_hidden, mesh,
                             dtype, device)
        x = torch.randn(batch, d_model, generator=torch.Generator(device).manual_seed(1),
                        device=device).to(dtype)
        y = tp_mlp_forward(params, x, mesh).float()
        want = F.gelu(x.float() @ params["w1"].float(), approximate="tanh") @ params["w2"].float()
        out[str(dtype).removeprefix("torch.")] = {
            "max_abs_err": float((y - want).abs().max()), "rel_rms": _rel_rms(y, want),
            "finite": bool(torch.isfinite(y).all()),
            "ms": cuda_time_ms(lambda: tp_mlp_forward(params, x, mesh), 50),
        }
    out["bars"] = {"float32_max_abs": TP_F32_ATOL, "bfloat16_rel_rms": TP_BF16_REL}
    emit(out)
    f32, bf16 = out["float32"], out["bfloat16"]
    if not (f32["max_abs_err"] <= TP_F32_ATOL and bf16["rel_rms"] <= TP_BF16_REL
            and f32["finite"] and bf16["finite"]):
        raise AssertionError(f"the tensor-parallel MLP disagrees with its plain version: {out}")
    return out


def _burst_kernels(gen: AllReduceLoadGen) -> dict:
    """The device's kernels inside one annotated burst, by name: a lead
    burst goes first, so that a trace that drops kernels at its head (as
    some late in a long run have) drops the lead burst's."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _warm_trace()
        gen.step()
        with torch.profiler.record_function("traced_burst"):
            gen.step()
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e.time_range for e in on_device if e.is_user_annotation and e.name == "traced_burst"]
    kernels = {}
    for e in on_device:
        if spans and not e.is_user_annotation and spans[0].start <= e.time_range.start <= spans[0].end:
            k = kernels.setdefault(e.name[:100], {"ms": 0.0, "calls": 0})
            k["ms"] += e.time_range.elapsed_us() / 1e3
            k["calls"] += 1
    return kernels


def phase_allreduce_loadgen(device: str = "cuda:0", seconds: float = ALLREDUCE_S,
                            attempts: int = 3) -> dict:
    """``AllReduceLoadGen()`` at its defaults (64 MB, 4 rounds a burst, bf16)
    on the mesh of the group of one for ``seconds``: rounds, bytes a round,
    the rate, the buffer's finiteness; then one burst under torch.profiler,
    its kernels by name and count (NCCL's among them), traced again up to
    ``attempts`` times while the trace holds none."""
    gen = AllReduceLoadGen(device=device)
    gen.warmup()
    stats = gen.run_for(seconds)
    for attempt in range(1, attempts + 1):
        kernels = _burst_kernels(gen)
        if kernels:
            break
    out = {
        "phase": "allreduce_loadgen", "mesh": mesh_shape(gen.mesh),
        "buffer_shape": list(gen.shape), "dtype": str(gen._x.dtype).removeprefix("torch."),
        "rounds_per_burst": gen.rounds_per_burst, "rounds": stats.rounds,
        "busy_s": stats.seconds,
        "burst_ms": stats.seconds / max(stats.rounds // gen.rounds_per_burst, 1) * 1e3,
        "bytes_per_round": stats.bytes_moved_per_round, "gbps": stats.achieved_gbps,
        "gbps_is": "world 1: the shard moved by one GPU's local copies, not a link's bandwidth",
        "finite": bool(torch.isfinite(gen._x).all()), "trace_attempts": attempt,
        "nccl_kernels": {k: v for k, v in kernels.items() if "nccl" in k.lower()},
        "burst_kernels": kernels,
    }
    emit(out)
    if not (stats.rounds > 0 and stats.achieved_gbps > 0 and out["finite"] and kernels):
        raise AssertionError(f"the collective rung did not run as expected: {out}")
    return out


def phase_allreduce_entry(work_dir: str) -> dict:
    """The slice container's command, ``python -m
    k8s_gpu_hpa_tpu_torch.loadgen.multihost`` with no WORKLOAD (so
    allreduce) and REPORT_S 2: its banner, two reports, then SIGTERM and
    exit 0; once with no topology (its own rendezvous) and once with
    COORDINATOR_ADDRESS=127.0.0.1:<free> NUM_PROCESSES=1, the two at once
    (each a group of one on the card), so their starts overlap."""
    module = "k8s_gpu_hpa_tpu_torch.loadgen.multihost"
    base = {k: v for k, v in os.environ.items()
            if k not in ("WORKLOAD", "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                         "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE")}
    base.update(REPORT_S="2", TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    runs = {"no_topology": base,
            "explicit": {**base, "COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
                         "NUM_PROCESSES": "1"}}
    out = {"phase": "allreduce_entry"}
    entries = {name: _Entry(module, env) for name, env in runs.items()}
    banners, codes = {}, {}
    try:
        for name, entry in entries.items():
            banners[name] = entry.wait_for("tpu-test multihost loadgen")
            entry.wait_for("rounds=", count=2)
    finally:
        for name, entry in entries.items():
            codes[name] = entry.stop()
    for name, entry in entries.items():
        out[name] = {"exit_code": codes[name], "banner": banners[name],
                     "reports": [ln for ln in entry.lines if ln.startswith("rounds=")]}
    emit(out)
    for name in runs:
        got = out[name]
        if (got["exit_code"] != 0 or len(got["reports"]) < 2
                or "(allreduce): process 0/1 " not in got["banner"]
                or "mesh={'data': 1, 'model': 1}" not in got["banner"]):
            raise AssertionError(f"the allreduce entry point did not run as expected: {got}")
    return out


def _pair(body, work_dir: str, device: str, *args) -> list[dict]:
    """``body(out_dir, *args)`` on two gloo ranks sharing ``device``, with a
    directory of its own under ``work_dir``: what each rank saved, by rank,
    with the pair's wall seconds."""
    out_dir = Path(tempfile.mkdtemp(prefix=body.__name__, dir=work_dir))
    t0 = time.perf_counter()
    code = launch(body, (str(out_dir), *args), devices=[device, device], backend="gloo",
                  timeout_s=DP_TIMEOUT_S, join_timeout_s=5 * DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"a {body.__name__} rank exited with code {code}")
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    for r in ranks:
        r["wall_s"] = wall
    return ranks


def _save_rank(out_dir: str, obj: dict) -> None:
    torch.save(obj, Path(out_dir) / f"rank{dist.get_rank()}.pt")


def _dp_batch(batch: int, image: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """train_dp's global batch: NCHW images in channels_last memory, the
    first half N(0, 1) and the second N(2, 1), and labels; from DP_SEED."""
    gen = torch.Generator().manual_seed(DP_SEED)
    images = torch.randn(batch, image, image, 3, generator=gen)
    images[batch // 2:] += 2.0
    labels = torch.randint(0, 10, (batch,), generator=gen)
    return images.to(device).permute(0, 3, 1, 2), labels.to(device)


def _dp_step(gen: TrainLoadGen, images: torch.Tensor, labels: torch.Tensor) -> dict:
    """One step of ``gen`` on its data shard of the global batch: the loss,
    the shard's logits, each parameter's update and each BatchNorm's batch
    statistics, on the CPU."""
    n = images.shape[0] // gen.n_data
    shard = slice(gen.data_index * n, (gen.data_index + 1) * n)
    before = {k: p.detach().clone() for k, p in gen.model.named_parameters()}
    seen = {}
    hook = gen.model.head.register_forward_hook(lambda m, a, y: seen.update(logits=y.detach()))
    loss = float(gen.train_step(images[shard], labels[shard]))
    hook.remove()
    return {
        "data_index": gen.data_index, "loss": loss, "logits": seen["logits"].float().cpu(),
        "updates": {k: (p.detach() - before[k]).cpu() for k, p in gen.model.named_parameters()},
        "stats": {k: (m.batch_mean.cpu(), m.batch_var.cpu())
                  for k, m in gen.model.named_modules() if isinstance(m, BatchNorm)},
    }


def train_dp_rank(out_dir: str, batch: int, image: int, small: bool, dtype: torch.dtype,
                  device: str) -> None:
    """One of train_dp's two ranks: the training generator over the mesh of
    both, one step on its half of the global batch."""
    gen = TrainLoadGen(mesh=make_mesh(), batch_size=batch, image_size=image, small=small,
                       dtype=dtype, device=device)
    step = _dp_step(gen, *_dp_batch(batch, image, device))
    step["backend"] = dist.get_backend(gen.mesh.get_group("data"))
    _save_rank(out_dir, step)


def _steps(gen: TrainLoadGen, n: int = 3) -> list[list[float]]:
    """``n`` steps: each one's loss and images/s."""
    out = []
    for _ in range(n):
        busy = gen.step()
        out.append([gen.stats().last_loss, gen.batch_size / busy])
    return out


def _worst(rel: dict) -> list:
    name = max(rel, key=rel.get)
    return [name, rel[name]]


def phase_train_dp(work_dir: str, device: str = "cuda:0", batch: int = TRAIN_BATCH,
                   image: int = TRAIN_IMAGE, small: bool = False,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """Data-parallel training at the shipped tpu-train sizes.  (1) Over a
    group of one (NCCL), ``TrainLoadGen(mesh=make_mesh())`` takes three
    steps whose losses equal ``TrainLoadGen()``'s bit for bit, from the same
    seed; then a generator of that group takes one step on a global batch
    whose halves differ in mean.  (2) Two ranks share the card over gloo,
    each one step on its half of that batch from the same parameters: the
    loss and the logits, every parameter's update and every BatchNorm's
    batch statistics within 0.06 of the RMS of (1)'s.  (3) What each half's
    own statistics would have read against (1)'s."""
    kw = {"batch_size": batch, "image_size": image, "small": small, "dtype": dtype,
          "device": device}
    plain_steps = _steps(TrainLoadGen(**kw))
    _group_of_one(device)
    try:
        mesh_steps = _steps(TrainLoadGen(mesh=make_mesh(), **kw))
        ref_gen = TrainLoadGen(mesh=make_mesh(), **kw)
        halves = {}  # each BatchNorm's input: each half's (unbiased var, mean), f32

        def per_half(name):
            def hook(module, args):
                halves[name] = [torch.var_mean(h, (0, 2, 3))
                                for h in args[0].detach().float().chunk(2)]
            return hook

        hooks = [m.register_forward_pre_hook(per_half(k))
                 for k, m in ref_gen.model.named_modules() if isinstance(m, BatchNorm)]
        ref = _dp_step(ref_gen, *_dp_batch(batch, image, device))
        for h in hooks:
            h.remove()
        del ref_gen
    finally:
        dist.destroy_process_group()
    ranks = sorted(_pair(train_dp_rank, work_dir, device, batch, image, small, dtype, device),
                   key=lambda r: r["data_index"])
    got = ranks[0]
    update_rel = {k: _rel_rms(got["updates"][k], u) if u.abs().max() > 0
                  else float(got["updates"][k].abs().max()) for k, u in ref["updates"].items()}
    stats_rel = {k: max(_rel_rms(got["stats"][k][0], mean), _rel_rms(got["stats"][k][1], var))
                 for k, (mean, var) in ref["stats"].items()}
    shard_rel = {k: max(max(_rel_rms(m.cpu(), ref["stats"][k][0]), _rel_rms(v.cpu(), ref["stats"][k][1]))
                        for v, m in halves[k]) for k in ref["stats"]}
    shard_sorted = sorted(shard_rel.values())
    out = {
        "phase": "train_dp", "model": "resnet18ish" if small else "resnet50 cifar_stem",
        "batch": batch, "image": image, "dtype": str(dtype).removeprefix("torch."),
        "world1_nccl": {"losses_plain": [s[0] for s in plain_steps],
                        "losses_mesh": [s[0] for s in mesh_steps],
                        "images_per_s_plain": [s[1] for s in plain_steps],
                        "images_per_s_mesh": [s[1] for s in mesh_steps],
                        "bit_identical": [s[0] for s in plain_steps] == [s[0] for s in mesh_steps]},
        "two_ranks": {"backend": [r["backend"] for r in ranks], "devices": [device, device],
                      "shard": batch // 2, "wall_s": ranks[0]["wall_s"]},
        "loss": got["loss"], "loss_world1": ref["loss"],
        "loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        "logits_rel_rms": _rel_rms(torch.cat([r["logits"] for r in ranks]), ref["logits"]),
        "updates_worst_rel_rms": _worst(update_rel),
        "updates_zero_in_world1": sum(float(u.abs().max()) == 0.0 for u in ref["updates"].values()),
        "updates": len(update_rel),
        "replicas_update_max_diff": max(float((ranks[1]["updates"][k] - u).abs().max())
                                        for k, u in got["updates"].items()),
        "bn_stats_worst_rel_rms": _worst(stats_rel), "batchnorms": len(stats_rel),
        "per_shard_stats_rel_rms": {
            "stem_bn": shard_rel["stem_bn"], "least": shard_sorted[0],
            "median": shard_sorted[len(shard_sorted) // 2], "most": shard_sorted[-1],
            "layers_over_bar": sum(r > DP_REL for r in shard_sorted)},
        "bar": DP_REL,
    }
    emit(out)
    if not out["world1_nccl"]["bit_identical"]:
        raise AssertionError(f"a mesh of one rank changed the losses: {out['world1_nccl']}")
    if (out["loss_rel"] > DP_REL or out["logits_rel_rms"] > DP_REL
            or out["updates_worst_rel_rms"][1] > DP_REL or out["bn_stats_worst_rel_rms"][1] > DP_REL
            or out["two_ranks"]["backend"] != ["gloo", "gloo"]):
        raise AssertionError(f"two data-parallel ranks disagree with one: {out}")
    return out


# The sequence and tensor-parallel paths over the mesh: ring attention across
# ranks (ops/ring_attention.py, the ringattn rung), tensor-parallel serving
# (models/transformer.py, DecodeLoadGen with a model axis) and sequence-parallel
# llm training.  World size 1 runs on
# NCCL; two ranks share the card over gloo, whose collectives and point-to-point
# hops stage CUDA tensors through host memory, so the pair's times are not rates.
# The TP prefill runs the hand-written flash forward on each rank's local heads;
# the ring is plain PyTorch, as the JAX package leaves it to XLA.
#: the ringattn rung's defaults (JAX's loadgen/ringattn.py and multihost.py)
RING_SHAPE = (1, 1024, 8, 128)
#: the ring against reference_attention: tests/test_ring_attention.py's bars,
#: and the gradients' (tests/test_flash_attention.py)
RING_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
RING_GRAD_TOL = 2e-4
#: the seconds the rung runs on the mesh of one
RINGATTN_S = 3.0
#: TP serving against one device: the port's bf16 bar on the RMS, and the
#: greedy tokens compared.  A step whose top two logits on the one device lie
#: within that bar of the logits' RMS is a near-tie: two roundings of the same
#: logits may order them either way (the flash forward splits each CTA's K/V
#: tiles over two warpgroups at the TP rank's 16 batch-heads, over one at the
#: one device's 32, and rounds P to bf16 against each warpgroup's own maximum;
#: that split alone moves the logits about as far as TP does)
TP_REL = 0.06
TP_TOKENS = 8
#: the least share of the greedy steps that are no near-tie
TP_DECIDED = 0.75
#: sequence-parallel training against one rank: the §2 loss bar of auto against
#: ring, and the bf16 bar on the RMS of the logits and of each leaf's update
SP_LOSS_ATOL = 0.05
SP_REL = 0.06
#: each rank's sequence at the llm rung's defaults
SP_SEQ = 2048
#: the seconds the moe rung runs on the mesh of one; its burst against the
#: same chain through moe_ffn_reference on the RMS (the port's bf16 bar)
MOE_S = 3.0
MOE_REL = 0.06
#: the EP pair at the container's width (d_model 512, d_ff 2048, 1024 tokens
#: a shard) with 4 experts over a model axis of 2, and the PP pair at
#: PipelineConfig()'s, against one device: tests/test_parallelism.py's bars
#: in f32 (the output 2e-5, the gradients 2e-4; the pipeline's in units of
#: their RMS) and the port's bf16 bar
EP_SIZES = dict(d_model=512, d_ff=2048, n_experts=4)
EP_TOKENS = 1024
PAR_TOL = 2e-5
PAR_GRAD_TOL = 2e-4
PAR_BF16_REL = 0.06
PP_BATCH = 64
PP_MICRO = 4


def _within(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """|got - want| <= tol + tol·|want| everywhere (numpy's assert_allclose
    with rtol = atol = tol, the JAX tests' form)."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()), "tol": tol,
            "out_of_tol": int((diff > tol + tol * want.abs()).sum()),
            "finite": bool(torch.isfinite(got).all())}


def _ring_inputs() -> dict[str, torch.Tensor]:
    gen = torch.Generator().manual_seed(DP_SEED)
    b, s, h, d = RING_SHAPE
    return {name: torch.randn(b, 2 * s, h, d, generator=gen) for name in ("q", "k", "v", "do")}


def ring_parity_rank(out_dir: str, x: dict, device: str) -> None:
    """One of ring_parity's two ranks: its shard of the ring's output in f32
    and bf16, causal, and the f32 gradients of its shards."""
    mesh = make_mesh()
    index, s = mesh.get_local_rank(DATA_AXIS), RING_SHAPE[1]
    shard = {k: v[:, index * s:(index + 1) * s].to(device) for k, v in x.items()}
    out = {"index": index, "backend": dist.get_backend(mesh.get_group(DATA_AXIS))}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (shard[n].to(dtype) for n in "qkv")
        out[str(dtype).removeprefix("torch.")] = ring_attention(q, k, v, mesh,
                                                                causal=True).float().cpu()
    q, k, v = (shard[n].detach().requires_grad_() for n in "qkv")
    ring_attention(q, k, v, mesh, causal=True).backward(shard["do"])
    out["grads"] = [t.grad.cpu() for t in (q, k, v)]
    torch.cuda.synchronize(device)
    _save_rank(out_dir, out)


def phase_ring_parity(work_dir: str, device: str = "cuda:0") -> dict:
    """Ring attention at the rung's default (batch 1, two ranks of 1024
    tokens, 8 heads of 128, causal) on two gloo ranks sharing the card,
    against ``reference_attention`` over the whole sequence on one device:
    the output in f32 and bf16 at tests/test_ring_attention.py's bars, and
    the f32 gradients of q, k and v against autograd through the reference
    at 2e-4."""
    x = _ring_inputs()
    want = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x[n].to(device, dtype) for n in "qkv")
        want[str(dtype).removeprefix("torch.")] = reference_attention(q, k, v, causal=True).float()
    q, k, v = (x[n].to(device).detach().requires_grad_() for n in "qkv")
    reference_attention(q, k, v, causal=True).backward(x["do"].to(device))
    want["grads"] = [t.grad for t in (q, k, v)]
    ranks = sorted(_pair(ring_parity_rank, work_dir, device, x, device),
                   key=lambda r: r["index"])
    out = {"phase": "ring_parity", "bshd": [RING_SHAPE[0], 2 * RING_SHAPE[1], *RING_SHAPE[2:]],
           "causal": True, "ranks": 2, "backend": [r["backend"] for r in ranks],
           "devices": [device, device], "pair_wall_s": ranks[0]["wall_s"]}
    for name, tol in RING_TOL.items():
        got = torch.cat([r[name] for r in ranks], dim=1)
        out[name] = _within(got, want[name].cpu(), tol)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = torch.cat([r["grads"][i] for r in ranks], dim=1)
        out[name] = _within(got, want["grads"][i].cpu(), RING_GRAD_TOL)
    emit(out)
    checks = [out[n] for n in (*RING_TOL, "dq", "dk", "dv")]
    if out["backend"] != ["gloo", "gloo"] or any(c["out_of_tol"] or not c["finite"] for c in checks):
        raise AssertionError(f"the ring across two ranks disagrees with the reference: {out}")
    return out


def phase_ringattn_loadgen(device: str = "cuda:0", seconds: float = RINGATTN_S) -> dict:
    """``RingAttentionLoadGen()`` at its defaults (1024 tokens a rank, 8 heads
    of 128, bf16, 8 passes a burst) on the mesh of the NCCL group of one for
    ``seconds``: bursts, the context, TFLOP/s by JAX's causal formula."""
    gen = RingAttentionLoadGen(device=device)
    gen.warmup()
    ms = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ms.append(gen.step() * 1e3)
    stats = gen.stats()
    probe = gen._burst()
    out = {"phase": "ringattn_loadgen", "mesh": mesh_shape(gen.mesh),
           "bshd": [gen.batch, gen.seq, gen.heads, gen.head_dim], "dtype": "bfloat16",
           "passes_per_burst": gen.passes_per_burst, "bursts": stats.bursts,
           "context_length": stats.context_length, "burst_ms_median": sorted(ms)[len(ms) // 2],
           "achieved_tflops": stats.achieved_tflops, "busy_s": stats.seconds,
           "finite": math.isfinite(probe),
           "tflops_is": "JAX's causal formula over the busy host seconds; a ring of one moves "
                        "no block"}
    emit(out)
    if not (stats.bursts > 0 and stats.context_length == RING_SHAPE[1]
            and stats.achieved_tflops > 0 and out["finite"]):
        raise AssertionError(f"the ringattn rung did not run as expected: {out}")
    return out


def start_ringattn_entry(work_dir: str) -> tuple[_Entry, float]:
    """The slice container's command with WORKLOAD=ringattn and REPORT_S 2,
    started, and the time it was started."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE")}
    env.update(WORKLOAD="ringattn", REPORT_S="2",
               TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    return _Entry("k8s_gpu_hpa_tpu_torch.loadgen.multihost", env), time.perf_counter()


def phase_ringattn_entry(work_dir: str, started: tuple[_Entry, float] | None = None) -> dict:
    """The slice container's command with WORKLOAD=ringattn and REPORT_S 2
    (``started`` by ``start_ringattn_entry``, or here): its banner, two
    reports at the rung's context, then SIGTERM and exit 0; ``wall_s`` from
    its start to its exit."""
    entry, t0 = started or start_ringattn_entry(work_dir)
    try:
        banner = entry.wait_for("tpu-test multihost loadgen")
        entry.wait_for("bursts=", count=2)
    finally:
        code = entry.stop()
    reports = [ln for ln in entry.lines if ln.startswith("bursts=")]
    out = {"phase": "ringattn_entry", "exit_code": code, "banner": banner, "reports": reports,
           "wall_s": time.perf_counter() - t0}
    emit(out)
    last = dict(f.split("=", 1) for f in reports[-1].split()) if reports else {}
    if (code != 0 or len(reports) < 2 or "(ringattn): process 0/1 " not in banner
            or "mesh={'data': 1, 'model': 1}" not in banner
            or last.get("ctx") != str(RING_SHAPE[1])):
        raise AssertionError(f"the ringattn entry point did not run as expected: {out}")
    return out


def _moe_chain(gen: MoELoadGen, x: torch.Tensor) -> torch.Tensor:
    """``gen``'s burst from ``x`` with each FFN through
    ``moe_ffn_reference``: at a model axis of 1 the rank holds every expert."""
    with torch.no_grad():
        for i in range(gen.ffns_per_burst):
            x = gen._renorm(x + moe.moe_ffn_reference(gen._params, gen.cfg, x), i)
    return x


def phase_moe_loadgen(device: str = "cuda:0", seconds: float = MOE_S) -> dict:
    """``MoELoadGen()`` at the container's defaults (d_model 512, d_ff 2048,
    1024 tokens, 2 experts, 8 FFNs a burst, bf16) on the mesh of the NCCL
    group of one, where the exchange moves nothing, for ``seconds``: burst
    ms, tokens/s and the exchange's bytes by JAX's formula; one profiled
    burst's kernels and the device's idle share of its host wall time; one
    burst against the same chain through moe_ffn_reference."""
    gen = MoELoadGen(device=device)
    gen.warmup()
    ms = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ms.append(gen.step() * 1e3)
    stats = gen.stats()
    kernels, wall_ms = _after_lead(gen.step)
    busy_ms = sum(k["ms"] for k in kernels.values())
    x = gen._x.clone()
    got, want = gen._burst(x).float(), _moe_chain(gen, x).float()
    out = {"phase": "moe_loadgen", "mesh": mesh_shape(gen.mesh), "d_model": gen.cfg.d_model,
           "d_ff": gen.cfg.d_ff, "n_experts": gen.cfg.n_experts,
           "tokens_per_shard": gen.tokens_per_shard, "ffns_per_burst": gen.ffns_per_burst,
           "dtype": "bfloat16", "bursts": stats.bursts, "burst_ms_median": sorted(ms)[len(ms) // 2],
           "tokens_per_sec": stats.tokens_per_sec, "a2a_bytes_per_burst": stats.a2a_bytes_per_burst,
           "a2a_gbps": stats.a2a_gbps, "busy_s": stats.seconds,
           "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": None if not kernels else max(0.0, 1.0 - busy_ms / wall_ms),
           "kernel_calls": sum(k["calls"] for k in kernels.values()),
           "top_kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12]),
           "reference_rel_rms": _rel_rms(got, want), "reference_bar": MOE_REL,
           "finite": bool(torch.isfinite(got).all())}
    emit(out)
    if not (stats.bursts > 0 and stats.a2a_bytes_per_burst == 0 and kernels and out["finite"]
            and out["reference_rel_rms"] <= MOE_REL):
        raise AssertionError(f"the moe rung did not run as expected: {out}")
    return out


def start_moe_entry(work_dir: str) -> tuple[_Entry, float]:
    """The slice container's command with WORKLOAD=moe and REPORT_S 2 as one
    process, started, and the time it was started."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE", "MODEL_PARALLELISM")}
    env.update(WORKLOAD="moe", REPORT_S="2",
               TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    return _Entry("k8s_gpu_hpa_tpu_torch.loadgen.multihost", env), time.perf_counter()


def phase_moe_entry(work_dir: str, started: tuple[_Entry, float] | None = None) -> dict:
    """The slice container's command with WORKLOAD=moe and REPORT_S 2 as
    one process (``started`` by ``start_moe_entry``, or here): its banner
    (the generator's mesh, a model axis of 1 at world 1), two reports, then
    SIGTERM and exit 0; ``wall_s`` from its start to its exit."""
    entry, t0 = started or start_moe_entry(work_dir)
    try:
        banner = entry.wait_for("tpu-test multihost loadgen")
        entry.wait_for("bursts=", count=2)
    finally:
        code = entry.stop()
    reports = [ln for ln in entry.lines if ln.startswith("bursts=")]
    out = {"phase": "moe_entry", "exit_code": code, "banner": banner, "reports": reports,
           "wall_s": time.perf_counter() - t0}
    emit(out)
    last = dict(f.split("=", 1) for f in reports[-1].split()) if reports else {}
    if (code != 0 or len(reports) < 2 or "(moe): process 0/1 " not in banner
            or "mesh={'data': 1, 'model': 1}" not in banner or int(last.get("bursts", 0)) <= 0):
        raise AssertionError(f"the moe entry point did not run as expected: {out}")
    return out


def _ep_inputs() -> torch.Tensor:
    gen = torch.Generator().manual_seed(DP_SEED)
    return torch.randn(EP_TOKENS, EP_SIZES["d_model"], generator=gen) * 0.5


def ep_parity_rank(out_dir: str, x: torch.Tensor, device: str) -> None:
    """One of ep_parity's two ranks (mesh (1, 2), two experts each): the EP
    output in f32 and bf16, and the f32 gradients of router, w1 and w2 with
    the loss scaled by ``replica_share`` and summed over their copies."""
    mesh = make_mesh(model_parallelism=2)
    out = {"model_index": mesh.get_local_rank(MODEL_AXIS),
           "backend": dist.get_backend(mesh.get_group(MODEL_AXIS))}
    x = x.to(device)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = moe.MoEConfig(**EP_SIZES, dtype=dtype)
        params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, mesh, device)
        ffn = moe.make_ep_moe_ffn(mesh, cfg)
        if dtype == torch.float32:
            params = {k: v.requires_grad_() for k, v in params.items()}
            y = ffn(params, x)
            (y.square().sum() * moe.replica_share(mesh)).backward()
            moe.sum_replicated_grads(params, mesh)
            out["grads"] = {k: v.grad.cpu() for k, v in params.items()}
        else:
            y = ffn(params, x.to(dtype))
        out[str(dtype).removeprefix("torch.")] = y.detach().float().cpu()
    torch.cuda.synchronize(device)
    _save_rank(out_dir, out)


def phase_ep_parity(work_dir: str, device: str = "cuda:0") -> dict:
    """The EP FFN at the container's width on two gloo ranks sharing the
    card (mesh (1, 2): a model axis of 2, 4 experts, 1024 tokens) against
    ``moe_ffn_reference`` on the one data shard on one device: the output
    in f32 at 2e-5 and in bf16 within 0.06 of its RMS, the f32 gradients of
    the router and both expert weights at 2e-4.  Every exchange crosses the
    host (gloo): the pair's time is not a rate."""
    x = _ep_inputs()
    want = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = moe.MoEConfig(**EP_SIZES, dtype=dtype)
        params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, device=device)
        if dtype == torch.float32:
            params = {k: v.requires_grad_() for k, v in params.items()}
            y = moe.moe_ffn_reference(params, cfg, x.to(device))
            y.square().sum().backward()
            want["grads"] = {k: v.grad.cpu() for k, v in params.items()}
        else:
            y = moe.moe_ffn_reference(params, cfg, x.to(device, dtype))
        want[str(dtype).removeprefix("torch.")] = y.detach().float().cpu()
    ranks = sorted(_pair(ep_parity_rank, work_dir, device, x, device),
                   key=lambda r: r["model_index"])
    out = {"phase": "ep_parity", "mesh": {"data": 1, "model": 2}, **EP_SIZES,
           "tokens": EP_TOKENS, "backend": [r["backend"] for r in ranks],
           "pair_wall_s": ranks[0]["wall_s"],
           "float32": [_within(r["float32"], want["float32"], PAR_TOL) for r in ranks],
           "bfloat16_rel_rms": [_rel_rms(r["bfloat16"], want["bfloat16"]) for r in ranks],
           "bars": {"float32": PAR_TOL, "bfloat16_rel_rms": PAR_BF16_REL, "grads": PAR_GRAD_TOL}}
    local_e = EP_SIZES["n_experts"] // 2
    for name in ("router", "w1", "w2"):
        got = (ranks[0]["grads"][name] if name == "router"
               else torch.cat([r["grads"][name] for r in ranks]))
        out[f"d{name}"] = _within(got, want["grads"][name], PAR_GRAD_TOL)
        if name == "router":
            out["drouter"]["replicas_equal"] = bool(torch.equal(ranks[0]["grads"]["router"],
                                                                ranks[1]["grads"]["router"]))
        else:
            assert all(r["grads"][name].shape[0] == local_e for r in ranks)
    emit(out)
    checks = [*out["float32"], out["drouter"], out["dw1"], out["dw2"]]
    if (out["backend"] != ["gloo", "gloo"] or any(c["out_of_tol"] or not c["finite"] for c in checks)
            or max(out["bfloat16_rel_rms"]) > PAR_BF16_REL or not out["drouter"]["replicas_equal"]):
        raise AssertionError(f"the EP FFN across two ranks disagrees with the reference: {out}")
    return out


def pp_parity_rank(out_dir: str, x: torch.Tensor, device: str) -> None:
    """One of pp_parity's two ranks (mesh (1, 2), four layers each): the
    pipeline's output and its stage's f32 gradients, the loss scaled by 1/2."""
    mesh = make_mesh(model_parallelism=2)
    cfg = pipeline.PipelineConfig(dtype=torch.float32)
    params = {k: v.requires_grad_() for k, v in
              pipeline.init_pp_params(torch.Generator().manual_seed(0), cfg, mesh, device).items()}
    y = pipeline.make_pp_forward(mesh, cfg, n_micro=PP_MICRO)(params, x.to(device))
    (y.square().sum() / 2).backward()
    torch.cuda.synchronize(device)
    _save_rank(out_dir, {"stage": mesh.get_local_rank(MODEL_AXIS), "y": y.detach().cpu(),
                         "grads": {k: v.grad.cpu() for k, v in params.items()},
                         "backend": dist.get_backend(mesh.get_group(MODEL_AXIS))})


def _worst_raw(got: torch.Tensor, want: torch.Tensor, other: torch.Tensor, tol: float) -> dict:
    """The element where ``got`` comes nearest ``_within``'s bar against
    ``want`` (or passes it by the most): its index, ``want`` there, and the
    errors of ``got`` and of ``other`` there."""
    got, want, other = got.double(), want.double(), other.double()
    over = (got - want).abs() - tol - tol * want.abs()
    i = int(over.argmax())
    return {"index": i, "want": float(want.flatten()[i]),
            "err": float((got - want).flatten()[i]), "other_err": float((other - want).flatten()[i])}


def phase_pp_parity(work_dir: str, device: str = "cuda:0") -> dict:
    """The pipeline at PipelineConfig()'s width (d_model 128, d_ff 256, 8
    layers) in f32 on two gloo ranks sharing the card (mesh (1, 2), 4
    microbatches of 16) against ``pp_forward_reference`` on one device in
    f64: the output at 2e-5 and each weight's gradient at 2e-4.  The same
    reference in f32 on one device is read beside it, with its error at the
    element where the pair comes nearest the bar (``worst``): against each
    other the two f32 results miss 2e-4 at an element, by f32 sums over
    gradients whose RMS is some 80-140.  Every stage returns the whole
    block."""
    cfg = pipeline.PipelineConfig(dtype=torch.float32)
    x = torch.randn(PP_BATCH, cfg.d_model, generator=torch.Generator().manual_seed(DP_SEED)) * 0.5
    init = pipeline.init_pp_params(torch.Generator().manual_seed(0), cfg, device=device)
    ref = {}
    for dtype in (torch.float64, torch.float32):
        params = {k: v.to(dtype).requires_grad_() for k, v in init.items()}
        y = pipeline.pp_forward_reference(params, cfg, x.to(device, dtype))
        y.square().sum().backward()
        ref[dtype] = y.detach().cpu(), {k: v.grad.cpu() for k, v in params.items()}
    (y64, g64), (y32, g32) = ref[torch.float64], ref[torch.float32]
    ranks = sorted(_pair(pp_parity_rank, work_dir, device, x, device), key=lambda r: r["stage"])
    out = {"phase": "pp_parity", "mesh": {"data": 1, "model": 2}, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "n_layers": cfg.n_layers, "batch": PP_BATCH, "n_micro": PP_MICRO,
           "reference": "float64, one device",
           "backend": [r["backend"] for r in ranks], "pair_wall_s": ranks[0]["wall_s"],
           "y": [_within(r["y"], y64, PAR_TOL) for r in ranks],
           "y_one_device_f32": _within(y32, y64, PAR_TOL),
           "bars": {"y": PAR_TOL, "grads": PAR_GRAD_TOL}}
    for name in ("w1", "w2"):
        got = torch.cat([r["grads"][name] for r in ranks])
        out[f"d{name}"] = {**_within(got, g64[name], PAR_GRAD_TOL),
                           "worst": _worst_raw(got, g64[name], g32[name], PAR_GRAD_TOL)}
        out[f"d{name}_one_device_f32"] = _within(g32[name], g64[name], PAR_GRAD_TOL)
    emit(out)
    checks = [*out["y"], out["dw1"], out["dw2"]]
    if out["backend"] != ["gloo", "gloo"] or any(c["out_of_tol"] or not c["finite"] for c in checks):
        raise AssertionError(f"the pipeline across two ranks disagrees with the reference: {out}")
    return out


def _burst_ms(gen: DecodeLoadGen, bursts: int = 10) -> float:
    t0 = time.perf_counter()
    for _ in range(bursts):
        gen.run_burst()
    return (time.perf_counter() - t0) * 1e3 / bursts


def phase_tp_serve_graph(device: str = "cuda:0") -> tuple[dict, int]:
    """The TP burst at the shipped serve sizes on the (1, 1) mesh of the NCCL
    group of one, captured as one CUDA graph (the communicator brought up by
    the eager burst before the capture), against the single-device graph
    burst from the same weights and prompt: tokens equal, the cache within
    0.06 of its RMS; both bursts' times.  Returns the TP run's flash
    launches (the captured burst's, times its replays)."""
    single = DecodeLoadGen(**SERVE_SIZES, window=3.0, device=device)
    tp = DecodeLoadGen(**SERVE_SIZES, window=3.0, device=device, mesh=make_mesh())
    for gen in (single, tp):
        gen.warmup()
    flash_attention_kernel.launches = 0
    tp.replays = 0
    runs = {}
    for name, gen in (("single", single), ("tp", tp)):
        gen.reset_state()
        gen.run_burst()
        tokens, cache, pos = gen.state()
        runs[name] = (tokens.clone(), {n: t.clone() for n, t in cache.items()}, pos)
    times = {name: _burst_ms(gen) for name, gen in (("single", single), ("tp", tp))}
    launches = flash_attention_kernel.launches + tp.replays * tp.flash_launches_per_burst
    (st, sc, sp), (tt, tc, tpos) = runs["single"], runs["tp"]
    out = {"phase": "tp_serve_graph", "sizes": SERVE_SIZES, "mesh": mesh_shape(tp.mesh),
           "backend": dist.get_backend(tp.mesh.get_group(MODEL_AXIS)),
           "burst_mode": tp.stats().burst_mode, "tokens_per_burst": tp.tokens_per_burst,
           "tokens_equal": torch.equal(st, tt), "pos": [sp, tpos],
           "cache_rel_rms": max(_rel_rms(tc[n].float(), sc[n].float()) for n in sc),
           "bit_identical": torch.equal(st, tt) and all(torch.equal(sc[n], tc[n]) for n in sc),
           "burst_ms_graph": times, "flash_launches_per_burst": tp.flash_launches_per_burst,
           "replays": tp.replays, "flash_launches": launches, "bar": TP_REL}
    emit(out)
    if (out["burst_mode"] != "cuda_graph" or not out["tokens_equal"] or sp != tpos
            or out["cache_rel_rms"] > TP_REL or tp.flash_launches_per_burst != tp.cfg.n_layers):
        raise AssertionError(f"the TP graph burst disagrees with the single-device one: {out}")
    return out, launches


def _greedy(prefill_fn, step_fn, params, prompt, cache, plen: int, forced=None) -> tuple:
    """The logits of the prefill and of ``TP_TOKENS - 1`` decode steps, and
    the greedy tokens: the prefill's argmax and each step's.  With
    ``forced`` [batch, TP_TOKENS] each step is fed ``forced``'s token
    instead of its own."""
    logits, _ = prefill_fn(params, prompt, cache)
    all_logits, tokens = [logits.float()], [logits.argmax(-1)]
    for i in range(TP_TOKENS - 1):
        fed = tokens[-1] if forced is None else forced[:, i]
        step_logits, _ = step_fn(params, fed, cache, plen + i)
        all_logits.append(step_logits.float())
        tokens.append(step_logits.argmax(-1))
    return torch.stack(all_logits, dim=1), torch.stack(tokens, dim=1)


def _head_groups_flash(groups: int):
    """``flash_attention`` called once for each of ``groups`` equal groups
    of heads: on one device, the attention a TP rank of ``groups`` runs, at
    its batch-heads and so with its ``fwd_split``."""
    flash = transformer.flash_attention

    def attn(q, k, v, causal=False):
        h = q.shape[2] // groups
        parts = [slice(i * h, (i + 1) * h) for i in range(groups)]
        return torch.cat([flash(q[:, :, g], k[:, :, g], v[:, :, g], causal=causal)
                          for g in parts], dim=2)

    return attn


def _one_device_greedy(gen: DecodeLoadGen, head_groups: int = 1) -> tuple:
    """``_greedy`` on one device with the full weights; with ``head_groups``
    > 1 the prefill's flash forward runs on that many groups of heads."""
    cfg, device = gen.cfg, gen.device
    cache = transformer.init_kv_cache(cfg, gen.batch, device)
    flash = transformer.flash_attention
    transformer.flash_attention = flash if head_groups == 1 else _head_groups_flash(head_groups)
    try:
        logits, tokens = _greedy(
            lambda p, t, c: transformer.prefill(p, cfg, t, c),
            lambda p, t, c, pos: transformer.decode_step(p, cfg, t, c, pos),
            gen.params, gen.prompt, cache, gen.prefill_len)
    finally:
        transformer.flash_attention = flash
    return logits.cpu(), tokens.cpu(), cache


def tp_serve_rank(out_dir: str, device: str, forced: torch.Tensor) -> None:
    """One of tp_serve_parity's two ranks: ``DecodeLoadGen`` at the shipped
    sizes with MODEL_PARALLELISM 2: the TP prefill's logits, the first
    greedy tokens and the cache slice they filled; the logits with the one
    device's tokens fed (``forced``); then the generator's own bursts and
    the flash forward's launches in them."""
    gen = DecodeLoadGen(**SERVE_SIZES, window=3.0, model_parallelism=2, device=device)
    cfg, plen = gen.cfg, gen.prefill_len
    prefill = transformer.make_tp_prefill(gen.mesh, cfg)
    step = transformer.make_tp_decode_step(gen.mesh, cfg)
    cache = transformer.init_tp_kv_cache(cfg, gen.batch, gen.mesh, device)
    logits, tokens = _greedy(prefill, step, gen.params, gen.prompt, cache, plen)
    filled = plen + TP_TOKENS - 1
    out = {"model": gen.mesh.get_local_rank(MODEL_AXIS), "mesh": mesh_shape(gen.mesh),
           "backend": dist.get_backend(gen.mesh.get_group(MODEL_AXIS)),
           "logits": logits.cpu(), "tokens": tokens.cpu(),
           "cache": {n: t[:, :, :, :filled].cpu() for n, t in cache.items()}}
    cache = transformer.init_tp_kv_cache(cfg, gen.batch, gen.mesh, device)
    out["forced_logits"] = _greedy(prefill, step, gen.params, gen.prompt, cache, plen,
                                   forced.to(device))[0].cpu()
    flash_attention_kernel.launches = 0
    gen.warmup()
    ms = [gen.step() * 1e3 for _ in range(2)]
    out.update(launches=flash_attention_kernel.launches, bursts=3, burst_ms=ms,
               burst_mode=gen.stats().burst_mode, peak=gen.peak_hbm_gbps,
               param_stream_factor=gen._param_stream_factor,
               bytes_per_burst=gen.bytes_per_burst())
    torch.cuda.synchronize(device)
    _save_rank(out_dir, out)


def phase_tp_serve_parity(work_dir: str, device: str = "cuda:0") -> tuple[dict, int]:
    """``DecodeLoadGen`` at deploy/tpu-serve-deployment.yaml's sizes with
    MODEL_PARALLELISM 2 on two gloo ranks sharing the card, against the
    single-device generator from the same weights and prompt: the prefill's
    logits, every step's logits with the one device's tokens fed, and the
    cache the first greedy tokens filled within 0.06 of their RMS; of the
    first 8 greedy tokens, each step's argmax with the one device's tokens
    fed equal wherever the step is no near-tie (``TP_REL``), at least
    ``TP_DECIDED`` of the steps no near-tie, and each row's own chain equal
    up to its first near-tie; each rank's flash forward launches, one a
    layer a burst.  Read beside them, the rounding spread behind the
    near-ties: the one device with a TP rank's attention split
    (``_head_groups_flash``), its tokens and logits against the pair's and
    the plain one device's.  Returns both ranks' launches."""
    ref = DecodeLoadGen(**SERVE_SIZES, window=3.0, device=device)
    cfg, plen = ref.cfg, ref.prefill_len
    logits, tokens, cache = _one_device_greedy(ref)
    filled = plen + TP_TOKENS - 1
    ref_cache = {n: t[:, :, :, :filled].float().cpu() for n, t in cache.items()}
    # the one device with a TP rank's attention split: its flash forward on
    # each half of the heads, at the rank's batch-heads
    split_logits, split_tokens, _ = _one_device_greedy(ref, head_groups=2)
    splits = [flash_attention.fwd_split(ref.batch * heads, plen, _sms(), cfg.head_dim)
              for heads in (cfg.n_heads, cfg.n_heads // 2)]
    del ref, cache
    ranks = sorted(_pair(tp_serve_rank, work_dir, device, device, tokens), key=lambda r: r["model"])
    got_cache = {n: torch.cat([r["cache"][n] for r in ranks], dim=2).float() for n in ("k", "v")}
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # [batch, steps]: the one device's top-2 gap
    tie_bar = TP_REL * float(logits.square().mean().sqrt())
    decided = margin > tie_bar
    # the free-running chains: equal up to each row's first near-tie
    before_tie = torch.cumprod(decided.long(), dim=1).bool()
    free_equal = all(bool((r["tokens"] == tokens)[before_tie].all()) for r in ranks)
    # fed the one device's tokens: the same argmax at every step that is no near-tie
    forced_equal = all(bool((r["forced_logits"].argmax(-1) == tokens)[decided].all())
                       for r in ranks)
    differ = (ranks[0]["tokens"] != tokens).nonzero().tolist()
    out = {
        "phase": "tp_serve_parity", "sizes": SERVE_SIZES, "mesh": ranks[0]["mesh"],
        "backend": [r["backend"] for r in ranks], "devices": [device, device],
        "logits_rel_rms": max(_rel_rms(r["logits"][:, 0], logits[:, 0]) for r in ranks),
        "forced_logits_rel_rms": max(_rel_rms(r["forced_logits"], logits) for r in ranks),
        "cache_rel_rms": max(_rel_rms(got_cache[n], ref_cache[n]) for n in got_cache),
        "tokens_equal": all(torch.equal(r["tokens"], tokens) for r in ranks),
        "tokens_equal_before_near_ties": free_equal,
        "forced_tokens_equal_where_decided": forced_equal,
        "near_tie_bar": tie_bar, "near_ties": int((~decided).sum()),
        "decided_share": float(decided.float().mean()),
        "tokens": tokens[0].tolist(), "tokens_differ_at": differ,
        "margins_there": [float(margin[b, t]) for b, t in differ],
        "margin_min": float(margin.min()), "margin_median": float(margin.median()),
        "forced_max_abs_logit_dev": max(float((r["forced_logits"] - logits).abs().max())
                                        for r in ranks),
        # the cause of the differing tokens: the flash forward's split
        "fwd_split_one_device_tp_rank": splits,
        "split_tokens_differ_from_one_device_at": (split_tokens != tokens).nonzero().tolist(),
        "split_tokens_equal_tp": all(torch.equal(r["tokens"], split_tokens) for r in ranks),
        "split_logits_rel_rms_tp": max(_rel_rms(r["logits"], split_logits) for r in ranks),
        "split_prefill_logits_rel_rms": {
            "one_device": _rel_rms(split_logits[:, 0], logits[:, 0]),
            "tp": max(_rel_rms(r["logits"][:, 0], split_logits[:, 0]) for r in ranks)},
        "split_max_abs_logit_dev_tp": max(float((r["logits"] - split_logits).abs().max())
                                          for r in ranks),
        "flash_launches": [r["launches"] for r in ranks],
        "flash_launches_per_burst": [r["launches"] / r["bursts"] for r in ranks],
        "burst_mode": [r["burst_mode"] for r in ranks],
        "burst_ms_eager_gloo": [r["burst_ms"] for r in ranks],
        "pod_peak_hbm_gbps": ranks[0]["peak"], "param_stream_factor": ranks[0]["param_stream_factor"],
        "pod_bytes_per_burst": ranks[0]["bytes_per_burst"],
        "pair_wall_s": ranks[0]["wall_s"], "bar": TP_REL,
    }
    emit(out)
    if (out["logits_rel_rms"] > TP_REL or out["forced_logits_rel_rms"] > TP_REL
            or out["cache_rel_rms"] > TP_REL or not free_equal or not forced_equal
            or out["decided_share"] < TP_DECIDED or out["backend"] != ["gloo", "gloo"]
            or out["flash_launches_per_burst"] != [cfg.n_layers] * 2
            or out["burst_mode"] != ["eager", "eager"]):
        raise AssertionError(f"TP serving on two ranks disagrees with one device: {out}")
    return out, sum(out["flash_launches"])


def _updates(grads: list[torch.Tensor], lr: float) -> list[torch.Tensor]:
    """Each leaf's SGD update in f32, before the cast back to the leaf's dtype."""
    return [(-lr * g.float()).cpu() for g in grads]


def llm_sp_rank(out_dir: str, device: str) -> None:
    """One of llm_sp's two ranks: ``LlmLoadGen`` over the mesh of both at the
    rung's defaults, its shard's logits, loss and f32 updates, then one step
    of the generator and the parameters it leaves."""
    gen = LlmLoadGen(mesh=make_mesh(), seq_per_device=SP_SEQ, device=device)
    logits = transformer.make_forward(gen.cfg, gen.mesh)(gen.params, gen.tokens)
    loss, grads = transformer.make_loss_and_grad(gen.cfg, "auto", gen.mesh)(gen.params, gen.tokens)
    out = {"index": gen.data_index, "logits": logits.cpu(), "loss": float(loss),
           "updates": _updates(grads, 1e-3), "max_seq": gen.cfg.max_seq,
           "backend": dist.get_backend(gen.mesh.get_group(DATA_AXIS))}
    del grads
    t0 = time.perf_counter()
    gen.warmup()
    out.update(step_s=time.perf_counter() - t0, step_loss=gen.stats().last_loss,
               params=[t.cpu() for t in transformer.param_leaves(gen.params)])
    _save_rank(out_dir, out)


def _slice_of_two(work_dir: str, ckpt_dir: str) -> list[dict]:
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("TPU_WORKER_HOSTNAMES", "HOSTS_PER_SLICE")}
    base.update(WORKLOAD="llm", REPORT_S="2", CHECKPOINT_DIR=ckpt_dir, CHECKPOINT_EVERY="1000",
                DIST_BACKEND="gloo", COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                TPU_TEST_INTENSITY_FILE=str(Path(work_dir) / "intensity"))
    return [dict(base, PROCESS_ID=str(pid)) for pid in (0, 1)]


def _run_slice(envs: list[dict], prefix: str, count: int) -> tuple[list[str], list[int]]:
    entries = [_Entry("k8s_gpu_hpa_tpu_torch.loadgen.multihost", env) for env in envs]
    try:
        entries[0].wait_for(prefix, seconds=300, count=count)
    finally:
        # every rank gets its SIGTERM before any is waited for, as a slice's
        # pods do at a scale-down: the ranks agree to stop at their next
        # step, so a rank signalled only once its peer has exited may be
        # shutting down already, past its handler, and die of the signal
        for entry in entries:
            entry.proc.send_signal(signal.SIGTERM)
        codes = [entry.wait() for entry in entries]
    return entries[0].lines, codes


def phase_llm_sp(work_dir: str, device: str = "cuda:0") -> dict:
    """Sequence-parallel training at the llm rung's defaults (2048 tokens a
    rank, d_model 512, 4 heads, 4 layers, bf16, SGD lr 1e-3) on two gloo
    ranks sharing the card, against one rank on the whole 4096-token
    sequence (attn_impl ring): the loss within 0.05, the logits and each
    leaf's f32 update within 0.06 of their RMS, both ranks' updated
    parameters identical and each within a bf16 step of the one rank's.
    Then the container's WORKLOAD=llm as two processes of one slice (gloo):
    reports, saves on SIGTERM, exits 0, and resumes from that save."""
    ref = LlmLoadGen(seq_per_device=2 * SP_SEQ, attn_impl="ring", device=device)
    logits = transformer.make_forward(ref.cfg)(ref.params, ref.tokens).cpu()
    loss, grads = transformer.make_loss_and_grad(ref.cfg, "ring")(ref.params, ref.tokens)
    updates = _updates(grads, 1e-3)
    del grads
    ref.warmup()
    ref_params = [t.cpu() for t in transformer.param_leaves(ref.params)]
    del ref
    torch.cuda.empty_cache()
    ranks = sorted(_pair(llm_sp_rank, work_dir, device, device), key=lambda r: r["index"])
    update_rel = [max(_rel_rms(r["updates"][i], u) for r in ranks) for i, u in enumerate(updates)]
    param_bad = sum(
        int(((p.float() - w.float()).abs() > TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * w.float().abs())
            .sum()) for p, w in zip(ranks[0]["params"], ref_params))
    out = {
        "phase": "llm_sp", "seq_per_rank": SP_SEQ, "context": ranks[0]["max_seq"],
        "backend": [r["backend"] for r in ranks], "devices": [device, device],
        "loss": [r["loss"] for r in ranks], "loss_one_rank": float(loss),
        "loss_diff": max(abs(r["loss"] - float(loss)) for r in ranks),
        "step_loss": [r["step_loss"] for r in ranks],
        "logits_rel_rms": _rel_rms(torch.cat([r["logits"] for r in ranks], dim=1), logits),
        "updates_worst_rel_rms": max(update_rel), "updates": len(update_rel),
        "replicas_identical": all(torch.equal(a, b) for a, b in
                                  zip(ranks[0]["params"], ranks[1]["params"])),
        "params_out_of_bf16_step": param_bad, "param_rtol": TRAIN_PARAM_RTOL,
        "rank_step_s": [r["step_s"] for r in ranks], "pair_wall_s": ranks[0]["wall_s"],
        "bars": {"loss": SP_LOSS_ATOL, "rel_rms": SP_REL},
    }
    if (out["context"] != 2 * SP_SEQ or out["loss_diff"] > SP_LOSS_ATOL
            or out["logits_rel_rms"] > SP_REL or out["updates_worst_rel_rms"] > SP_REL
            or not out["replicas_identical"] or param_bad or out["backend"] != ["gloo", "gloo"]):
        emit(out)
        raise AssertionError(f"two sequence-parallel ranks disagree with one: {out}")
    ckpt_dir = str(Path(work_dir) / "llm-sp-ckpt")
    lines, codes = _run_slice(_slice_of_two(work_dir, ckpt_dir), "steps=", 2)
    reports = [ln for ln in lines if ln.startswith("steps=")]
    final = [ln for ln in lines if ln.startswith("final checkpoint at step ")]
    saved = make_checkpoint_manager(ckpt_dir).all_steps()
    again, again_codes = _run_slice(_slice_of_two(work_dir, ckpt_dir), "steps=", 1)
    resumed = [ln for ln in again if ln.startswith("resumed from step ")]
    after = [int(ln.split()[0].split("=")[1]) for ln in again if ln.startswith("steps=")]
    out["entry"] = {"banner": next((ln for ln in lines if ln.startswith("tpu-test multihost")), None),
                    "reports": reports, "final": final, "exit_codes": codes, "saves": saved,
                    "resumed": resumed, "steps_after_resume": after, "restart_exit_codes": again_codes}
    emit(out)
    last = dict(f.split("=", 1) for f in reports[-1].split()) if reports else {}
    if (codes != [0, 0] or again_codes != [0, 0] or last.get("ctx") != str(2 * SP_SEQ)
            or not final or not saved or resumed != [f"resumed from step {saved[-1]} in {ckpt_dir}"]
            or not after or after[-1] <= saved[-1]):
        raise AssertionError(f"the llm slice of two processes did not run as expected: {out}")
    return out


#: the slice loop's bars: bench.py's multihost rung's, a scale-up to all 8
#: pods within the 60 s budget of the crossing and no scale event off a
#: slice boundary
SLICE_BUDGET_S = 60.0
SLICE_MAX_VIOLATIONS = 0


def _kernel_counts() -> dict[str, int]:
    return {"matmul_bf16": matmul_kernel.launches,
            **{f"flash_attention_{k}": v for k, v in _bwd_counts().items()}}


def phase_slice_loop(device: str = "cuda:0") -> dict:
    """The slice pod's closed loop on the group of one: the collective rung
    at its full width as ordinal 0, the shipped slice HPA in whole slices.
    The kernels' counts are set to 0 before it and read after: the slice
    path runs none of them."""
    gen = AllReduceLoadGen(device=device)
    gen.warmup()
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    result = run_slice_trial(gen)
    running = result.replicas[-1][2]
    out = {
        "phase": "slice_loop",
        "slice": f"a slice of one: world {dist.get_world_size()} on {dist.get_backend()}, "
                 "ordinal 0 of slice 0 on this card; its peer and slices 1-3 are mirror pods",
        "hpa_metric": trial.MULTIHOST_DUTY_SERIES, "time_scale": 1.0,
        "mesh": mesh_shape(gen.mesh), "buffer_shape": list(gen.shape),
        "scale_up_s": result.scale_up_s, "budget_s": SLICE_BUDGET_S,
        "spike_to_cross_s": result.spike_to_cross_s,
        "slice_boundary_violations": result.slice_boundary_violations,
        "violations_bar": SLICE_MAX_VIOLATIONS,
        "pods_running": running, "pods_max": MULTIHOST_MAX_REPLICAS, "quantum": MULTIHOST_QUANTUM,
        "rounds": gen.stats().rounds, "wall_s": time.perf_counter() - t0,
        "kernel_launches": _kernel_counts(),
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), v] for t, v in result.series],
    }
    emit(out)
    if (result.scale_up_s > SLICE_BUDGET_S or running != MULTIHOST_MAX_REPLICAS
            or result.slice_boundary_violations > SLICE_MAX_VIOLATIONS):
        raise AssertionError(f"the slice loop missed its bars: {out}")
    return out


def phase_slice_nvml(device: str = "cuda:0", seconds: float = 3.0) -> dict:
    """NVML's duty cycle while the collective rung runs under PacedLoad, as
    in the slice loop, at knob 1.0 and at 0.25, beside the generator's own
    busy share over its 3 s window: does NVML count the pod's copies and
    collectives as busy?  The answer is reported, not held to a bar."""
    gen = AllReduceLoadGen(device=device)
    gen.warmup()
    load = trial.PacedLoad(gen)
    uuid = f"GPU-{torch.cuda.get_device_properties(gen.device).uuid}"
    source = NvmlSource()
    out = {"phase": "slice_nvml", "mesh": mesh_shape(gen.mesh), "buffer_shape": list(gen.shape)}
    try:
        index = source.uuid_to_index(uuid)
        if index is None:
            raise AssertionError(f"NVML knows no device {uuid} (torch {gen.device})")
        for knob in (1.0, NVML_KNOB):
            load.set_intensity(knob)
            rows = _dwell(source, index, load, seconds, lead=load.duty.window + 1.0)
            out[f"knob_{knob}"] = {
                "nvml_duty_cycle": [c.duty_cycle for c, _ in rows],
                "nvml_mean": sum(c.duty_cycle for c, _ in rows) / len(rows),
                "generator_mean": sum(u for _, u in rows) / len(rows),
                "gpm_dram_bw_util": [c.hbm_bw_util for c, _ in rows],
            }
    finally:
        source.close()
    out["burst_ms"] = gen.stats().seconds / max(gen.stats().rounds // gen.rounds_per_burst, 1) * 1e3
    emit(out)
    return out


def phase_doctor_nvml() -> dict:
    """The NVML probe as an operator runs it, ``python -m
    k8s_gpu_hpa_tpu_torch.doctor nvml``: exit 0 (every NVML call the node
    exporter makes answered); its GPM lines are the finding."""
    proc = subprocess.run([sys.executable, "-m", "k8s_gpu_hpa_tpu_torch.doctor", "nvml"],
                          capture_output=True, text=True, timeout=120)
    lines = proc.stdout.splitlines()
    out = {"phase": "doctor_nvml", "exit_code": proc.returncode,
           "failed": [ln for ln in lines if ln.startswith("[FAIL]")],
           "gpm": [ln for ln in lines if "GPM" in ln], "summary": lines[-1] if lines else "",
           "stderr": proc.stderr[-2000:]}
    emit(out)
    if proc.returncode != 0:
        raise AssertionError(f"the NVML probe failed: {out}")
    return out


#: the HBM loop: bench.py's budget from the crossing to all replicas running
HBM_BUDGET_S = 60.0


class _PeakHold(HbmHold):
    """An HbmHold that, at each new peak of its held bytes, reads how far
    the allocator's bytes, its reservation and NVML's memory in use have
    grown since it was made."""

    def __init__(self, device: str, source: NvmlSource, index: int):
        super().__init__(device)
        self.source, self.index = source, index
        self.base = self._read()
        self.peak: dict = {"held_bytes": 0}

    def _read(self) -> dict:
        chip = next(c for c in self.source.sample() if c.accel_index == self.index)
        return {"allocated": torch.cuda.memory_allocated(self.device),
                "reserved": torch.cuda.memory_reserved(self.device),
                "nvml_used": chip.hbm_usage_bytes}

    def set_target(self, target_bytes: float) -> None:
        super().set_target(target_bytes)
        if self.held_bytes() > self.peak["held_bytes"]:
            now = self._read()
            self.peak = {"held_bytes": self.held_bytes(),
                         **{f"{k}_growth": now[k] - self.base[k] for k in now}}


def phase_hbm_pods_loop(device: str = "cuda:0") -> dict:
    """bench.py's HBM rung on the card at time scale 1, through
    run_hbm_pods_trial over a hold of real device memory.  The kernels'
    counts are set to 0 before it and read after: the loop runs none."""
    torch.cuda.empty_cache()
    source = NvmlSource()
    try:
        uuid = f"GPU-{torch.cuda.get_device_properties(device).uuid}"
        index = source.uuid_to_index(uuid)
        if index is None:
            raise AssertionError(f"NVML knows no device {uuid} (torch {device})")
        hold = _PeakHold(device, source, index)
        matmul_kernel.launches = 0
        _zero_counts()
        t0 = time.perf_counter()
        result = run_hbm_pods_trial(device, hold=hold)
        wall = time.perf_counter() - t0
    finally:
        source.close()
    running = result.replicas[-1][2]
    syncs = [
        {"t": round(t, 3), "replicas": r, "running": n,
         "read_gib": None if v[HBM_SERIES] is None else v[HBM_SERIES] / GIB, "reason": why}
        for (t, r, n), (_, v), (_, why) in zip(result.replicas, result.metrics, result.reasons)
    ]
    for sync in syncs:
        print(f"hbm sync: t={sync['t']:+.2f}s read={sync['read_gib']} GiB "
              f"replicas={sync['replicas']} running={sync['running']} ({sync['reason']})",
              flush=True)
    peak = hold.peak
    out = {
        "phase": "hbm_pods_loop", "hpa_metric": f"Pods {HBM_SERIES}", "target_gib": 13.0,
        "time_scale": 1.0, "scale_up_s": result.scale_up_s, "budget_s": HBM_BUDGET_S,
        "spike_to_cross_s": result.spike_to_cross_s, "pods_running": running,
        "pods_max": HBM_MAX_REPLICAS, "wall_s": wall,
        "peak": {**peak, "held_gib": peak["held_bytes"] / GIB,
                 **{f"{k}_gib": v / GIB for k, v in peak.items() if k.endswith("_growth")}},
        "kernel_launches": _kernel_counts(), "syncs": syncs,
        "replicas": [list(r) for r in result.replicas],
        "series": [[round(t, 2), v] for t, v in result.series],
    }
    emit(out)
    if result.scale_up_s > HBM_BUDGET_S or running != HBM_MAX_REPLICAS:
        raise AssertionError(f"the HBM loop missed its budget: {out['syncs']}")
    if peak["allocated_growth"] < peak["held_bytes"]:
        raise AssertionError(f"the held bytes are not on the card: {out['peak']}")
    return out


#: the queue joint: the shipped serve deployment's sizes, the container's
#: telemetry identity, and how long the depth grows and may take to drain
QUEUE_POD = "tpu-serve-real"
QUEUE_GROW_S = 3.0
QUEUE_DRAIN_S = 120.0


def phase_queue_external(work_dir: str, device: str = "cuda:0") -> dict:
    """The serving container's queue through the node exporter to the
    queue HPA (trial.QueueJoint), the container run as a user runs it."""
    telemetry = Path(work_dir) / "queue-telemetry"
    knob = Path(work_dir) / "queue-knob"
    knob.write_text("1.0")
    env = dict(os.environ, WORKLOAD="decode", PREFILL_LEN="512", N_HEADS="4",
               QUEUE_NAME="tpu-serve", TPU_TELEMETRY_DIR=str(telemetry), POD_NAME=QUEUE_POD,
               POD_NAMESPACE="default", REPORT_S="2", TPU_TEST_INTENSITY="1.0",
               TPU_TEST_INTENSITY_FILE=str(knob))
    uuid = f"GPU-{torch.cuda.get_device_properties(device).uuid}"
    source = NvmlSource()
    entry = _Entry("k8s_gpu_hpa_tpu_torch.loadgen", env)
    joint = None
    out: dict = {"phase": "queue_external", "env": {k: env[k] for k in (
        "WORKLOAD", "PREFILL_LEN", "N_HEADS", "QUEUE_NAME", "POD_NAME")}}
    try:
        out["banner"] = entry.wait_for("tpu-test decode loadgen")
        attribution = parse_list_response(kubelet_response({QUEUE_POD: [uuid]}), GPU_RESOURCE,
                                           resolve_uuid=source.uuid_to_index)
        out["kubelet_attribution"] = {str(k): list(v) for k, v in attribution.items()}
        deadline = time.monotonic() + 60
        while not (telemetry / f"default_{QUEUE_POD}.json").exists():
            if time.monotonic() > deadline:
                raise AssertionError(f"no self-report in {telemetry}: {entry.lines[-20:]}")
            time.sleep(0.1)
        joint = QueueJoint(source, StaticAttributor(attribution), str(telemetry), QUEUE_POD)
        sweeps = [joint.sweep()]
        time.sleep(QUEUE_GROW_S)
        sweeps.append(joint.sweep())
        status = joint.hpa.sync_once()
        total = status.last_metric_values.get(f"external/{QUEUE_SERIES}")
        ratio = sweeps[-1][0] / 100.0
        want = 1 if abs(ratio - 1.0) <= 0.1 else min(max(math.ceil(ratio), 1), 4, 3)
        out["hpa"] = {"sum": total, "desired": status.desired_replicas,
                      "replicas": joint.target.replicas, "reason": status.last_reason,
                      "want": want, "conditions": status.conditions_as_k8s()}
        knob.write_text("0")
        t_drain = time.monotonic()
        while sweeps[-1][0] >= 1.0 and time.monotonic() - t_drain < QUEUE_DRAIN_S:
            time.sleep(1.0)
            sweeps.append(joint.sweep())
        out["drain_s"] = time.monotonic() - t_drain
    finally:
        if joint is not None:
            joint.close()
        source.close()
        code = entry.stop()
    stopped = [ln for ln in entry.lines if ln.startswith("stopped: ")]
    flash = int(stopped[-1].rsplit("flash=", 1)[1]) if stopped else 0
    out.update({
        "exit_code": code, "stopped": stopped,
        "reports": [ln for ln in entry.lines if ln.startswith("bursts=")],
        "sweeps": [{"file_depth": d, "served": v} for d, v in sweeps],
        "selector": QUEUE_SELECTOR, "flash_launches": flash,
        "report_removed": not (telemetry / f"default_{QUEUE_POD}.json").exists(),
    })
    emit(out)
    if any(v != [d] for d, v in sweeps):
        raise AssertionError(f"the served depth is not the self-reported one: {out['sweeps']}")
    if not sweeps[1][0] > sweeps[0][0]:
        raise AssertionError(f"the queue did not grow at knob 1.0: {out['sweeps']}")
    if total != sweeps[1][0] or status.desired_replicas != want or joint.target.replicas != want:
        raise AssertionError(f"the queue HPA's proposal is not JAX's formula: {out['hpa']}")
    if sweeps[-1][0] >= 1.0:
        raise AssertionError(f"the queue did not drain at knob 0: {out['sweeps'][-3:]}")
    if code != 0 or not out["report_removed"]:
        raise AssertionError(f"the container did not stop cleanly: {entry.lines[-20:]}")
    if flash <= 0:
        raise AssertionError(f"the serving container launched the flash kernel no time: {stopped}")
    return out


def phase_simulate(headline: tuple[float, float], serve: tuple[float, float]) -> dict:
    """The scenario simulator and the port's YAML reader on this machine:
    ``headline`` and ``serve`` are each live loop's measured
    signal ceiling and scale_up_s.  The simulated verdicts on those ceilings
    must agree with the live loops, which reached 4 replicas."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    bundle = default_bundle()
    for name, docs in bundle.items():
        if load_yaml_all(to_yaml(docs)) != docs:
            raise AssertionError(f"{name} does not read back as it was written")
    hpas = {path.name: load_yaml(path.read_text())
            for path in sorted(trial.DEPLOY.glob("*-hpa.yaml"))}
    parsed = {name: [type(m).__name__ for m in metrics_from_manifest(doc)]
              for name, doc in hpas.items()}
    runs = {}
    for name, (ceiling, live_s) in (("tpu-test-hpa.yaml", headline),
                                    ("tpu-serve-hpa.yaml", serve)):
        report = simulate.run_scenario(hpas[name], "spike", saturated_pct=ceiling)
        runs[name] = {"saturated_pct": ceiling, "note": report.target_note,
                      "simulated_scale_up_s": report.scale_up_latency,
                      "live_scale_up_s": live_s, "scale_events": report.scale_events}
        print(f"simulate {name}: ceiling {ceiling:.2f}, simulated scale-up "
              f"{report.scale_up_latency} s beside the live loop's {live_s:.2f} s; "
              f"{report.target_note}", flush=True)
    slice_report = simulate.run_scenario(hpas["tpu-test-multihost-hpa.yaml"], "spike")
    cpu = run_cpu_resource_trial()
    wall = time.perf_counter() - t0
    out = {
        "phase": "simulate", "bundle_files": len(bundle), "hpa_files": parsed,
        "runs": runs, "slice_scale_events": slice_report.scale_events,
        "slice_scale_up_s": slice_report.scale_up_latency,
        "cpu_resource": {"scale_up_s": cpu.scale_up_s, "replicas_reached": cpu.replicas_reached},
        # the port reads no YAML through a library, whether or not one is here
        "yaml_loaded": "yaml" in sys.modules,
        "pyyaml_installed": importlib.util.find_spec("yaml") is not None,
        "kernel_launches": _kernel_counts(),
        "wall_s": wall,
    }
    emit(out)
    for name, run in runs.items():
        reachable = (run["note"] or "").endswith("target reachable")
        if not reachable or run["simulated_scale_up_s"] is None:
            raise AssertionError(f"the simulator disagrees with the live loop on {name}: {run}")
    events = slice_report.scale_events
    if not events or events[-1][2] != MULTIHOST_MAX_REPLICAS or any(
            a % MULTIHOST_QUANTUM or b % MULTIHOST_QUANTUM for _, a, b in events):
        raise AssertionError(f"the slice HPA's spike left whole slices: {events}")
    if cpu.replicas_reached != 4:
        raise AssertionError(f"the cpu rung reached {cpu.replicas_reached} replicas")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the simulator launched a kernel: {out['kernel_launches']}")
    return out


#: the signal-latency rung as the JAX package gives it (bench.py's
#: run_rung_signal_latency on a virtual clock, so exact)
SIGNAL_LATENCY_EXPECTED = {
    "changes_total": 3, "changes_scaled": 3,
    "sync_latency_p50_s": 15.0, "sync_latency_p95_s": 15.0,
    "scale_latency_p50_s": 15.0, "scale_latency_p95_s": 15.0,
    "budget_s": 60.0, "within_budget": True, "trace_spans": 2162, "final_replicas": 5,
}
#: the traced spike's spans by kind on deploy/tpu-test-hpa.yaml, the JAX
#: package's (simulate.run_scenario(..., trace=True), 420 s)
TRACE_SPIKE_SPANS = {
    "scrape": 1680, "exporter_sample": 840, "rule_eval": 420, "adapter_query": 28,
    "hpa_sync": 28, "scale_event": 2, "workload_change": 1,
}


def _self_metrics_payload(pipe) -> str:
    """The pipeline's self-metric series as Prometheus answers
    ``SELF_METRICS_QUERY``: an instant-query payload read from its TSDB."""
    now = pipe.clock.now()
    results = [
        {"metric": {"__name__": name, **dict(sample.labels)}, "value": [now, str(sample.value)]}
        for name in SELF_METRIC_NAMES
        for sample in pipe.db.instant_vector(name)
    ]
    return json.dumps({"status": "success", "data": {"result": results}})


def phase_trace() -> dict:
    """The tracing plane: the signal-latency rung, its SLO alerts and
    self-metrics, and the traced spike's spans, lineages and JSONL round
    trip (the module docstring, phase 41, has the bars)."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    run = trial.signal_latency_run()
    rung = trial.signal_latency_rung(run.pipe)
    self_metrics = check_self_metrics(_self_metrics_payload(run.pipe))
    report = simulate.run_scenario(
        load_yaml((trial.DEPLOY / "tpu-test-hpa.yaml").read_text()), "spike", trace=True
    )
    tracer, base = report.tracer, report.trace_base
    kinds: dict[str, int] = {}
    for span in tracer.spans:
        kinds[span.kind] = kinds.get(span.kind, 0) + 1
    by_id = index_spans(tracer.spans)
    lineages = []
    for event in tracer.spans_of("scale_event"):
        lin = lineage_of(event, by_id)
        lineages.append({
            "span_id": event.span_id, "t": event.start - base,
            "from": event.attrs["from_replicas"], "to": event.attrs["to_replicas"],
            "complete": lin["complete"],
            "hops": [[h["kind"], len(h["span_ids"]), h["first_ts"] - base, h["last_ts"] - base]
                     for h in lin["hops"]],
        })
    prop = propagation_report(tracer.spans)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.jsonl"
        written = tracer.write_jsonl(path)
        round_trip = [s.as_dict() for s in read_jsonl(path)] == [s.as_dict() for s in tracer.spans]
    wall = time.perf_counter() - t0
    out = {
        "phase": "trace", "signal_latency": rung, "slo_alerts_fired": run.fired,
        "self_metrics": self_metrics, "spike_spans_by_kind": kinds,
        "spike_propagation": {k: v for k, v in prop.items() if k != "changes"},
        "spike_changes": prop["changes"], "spike_lineages": lineages,
        "jsonl_spans": written, "jsonl_round_trip": round_trip,
        "kernel_launches": _kernel_counts(), "wall_s": wall,
    }
    emit(out)
    got = {k: rung[k] for k in SIGNAL_LATENCY_EXPECTED}
    if got != SIGNAL_LATENCY_EXPECTED:
        raise AssertionError(f"the signal-latency rung differs from the JAX package's: {got}")
    if run.fired:
        raise AssertionError(f"SLO alerts fired on a clean run: {run.fired}")
    if kinds != TRACE_SPIKE_SPANS:
        raise AssertionError(f"the traced spike's spans differ from the JAX package's: {kinds}")
    if not lineages or not all(lin["complete"] for lin in lineages):
        raise AssertionError(f"a scale event's lineage is incomplete: {lineages}")
    if not round_trip:
        raise AssertionError("the trace changed on its JSONL round trip")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the tracing plane launched a kernel: {out['kernel_launches']}")
    return out


#: the canned storm as the JAX package gives it (chaos.run_fault_storm at a
#: 12 s pod start, on a virtual clock, so exact)
CHAOS_EXPECTED = {
    "settled_replicas": 3, "all_recovered": True, "spurious_scale_events_during_blackout": 0,
    "blackout_condition_observed": True,
    "mttr_s": {"exporter_outage/exporter/chaos-node-1@30s": 8.0, "scrape_blackout@180s": 15.0,
               "node_preempt/chaos-node-0@420s": 11.0, "crashloop/tpu-test@660s": 37.0},
    "detection_s": {"exporter_outage/exporter/chaos-node-1@30s": 0.0,
                    "scrape_blackout@180s": 0.0, "node_preempt/chaos-node-0@420s": 0.0,
                    "crashloop/tpu-test@660s": 0.0},
}
#: the same storm's trace, and the shipped alerts (shipped_alert_rules)
#: evaluated on its TSDB each second, as the JAX package's fire them: only
#: TpuAutoscaleSignalAbsent, firing from 375 s (60 s of for: into the
#: 315-405 s blackout) until 415 s
STORM_EXPECTED = {
    "trace_spans": 8979, "fault_window_spans": [1954, 2790, 4967, 6851],
    "alerts_firing": {"TpuAutoscaleSignalAbsent": [[375.0, 415.0]]},
}
#: the SLO check as the JAX package gives it (simulate.run_slo_check)
SLO_BURN_EXPECTED = {
    "clean_false_positives": [],
    "fault_first_fired": {"SLOScrapeSuccessFastBurn": 140.0, "SLOScrapeSuccessSlowBurn": 127.0},
    "fast_detection_s": 20.0, "slow_detection_s": 7.0, "ok": True,
}
ALERT_GROUPS = ("tpu-pipeline-alerts", "tpu-slo-burn")


def _alerts_payload(evaluator) -> str:
    """An evaluator's alerts as Prometheus's ``/api/v1/alerts`` lists them:
    the firing ones, each with its ``alertname`` label."""
    alerts = [
        {"state": "firing", "labels": {"alertname": i["name"], **i["labels"]},
         "annotations": i["annotations"], "activeAt": i["active_since"]}
        for i in evaluator.firing_alert_instances()
    ]
    return json.dumps({"status": "success", "data": {"alerts": alerts}})


def _storm_with_alerts() -> tuple[dict, str, str]:
    """The canned storm with the shipped alerts evaluated on its TSDB each
    second (they only read it).  Returns the storm's result with
    ``alerts_firing``, each alert's firing runs as [start, end), and the
    alerts payloads at the first tick that any alert fired and at the end."""
    ticks, held = [], {}

    def attach(pipe, _schedule):
        evaluator = held["evaluator"] = RuleEvaluator(pipe.db, [], alerts=shipped_alert_rules())

        def tick():
            evaluator.evaluate_once()
            ticks.append((pipe.clock.now(), evaluator.firing_alerts()))
            if ticks[-1][1] and "firing" not in held:
                held["firing"] = _alerts_payload(evaluator)
            pipe.clock.call_later(1.0, tick)

        pipe.clock.call_later(1.0, tick)

    storm = run_fault_storm(pod_start_latency=trial.BASE_POD_START_LATENCY, on_pipeline=attach)
    runs: dict[str, list[list[float | None]]] = {}
    before: set[str] = set()
    for t, names in ticks:
        for name in sorted(set(names) - before):
            runs.setdefault(name, []).append([t, None])
        for name in before - set(names):
            runs[name][-1][1] = t
        before = set(names)
    storm["alerts_firing"] = runs
    final = _alerts_payload(held["evaluator"])
    return storm, held.get("firing", final), final


def phase_chaos() -> dict:
    """The chaos plane and the shipped alerts: the storm and SLO rungs, the
    storm again with the shipped alerts evaluated on it, the
    PrometheusRule's alert groups read back from gen-manifests' file, and
    the doctor's alert probe on the alerts in and after the blackout (the
    module docstring, phase 42, has the bars)."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    rung = trial.chaos_storm_rung()
    storm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    storm, firing_payload, final_payload = _storm_with_alerts()
    alerts_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    slo = trial.slo_burn_rung()
    slo_s = time.perf_counter() - t2
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        code = cli_main(["gen-manifests", "-o", tmp])
        (rule_doc,) = load_yaml_all((Path(tmp) / "tpu-test-prometheusrule.yaml").read_text())
    read_back = {g["name"]: g for g in rule_doc["spec"]["groups"] if g["name"] in ALERT_GROUPS}
    rendered = {g["name"]: g for g in prometheusrule_manifest()["spec"]["groups"]
                if g["name"] in ALERT_GROUPS}
    try:
        check_alerts(firing_payload)
        blackout_probe = "passed"
    except AssertionError as err:
        blackout_probe = str(err)
    final_probe = check_alerts(final_payload)
    wall = time.perf_counter() - t0
    out = {
        "phase": "chaos", "chaos_storm": rung, "storm_faults": storm["faults"],
        "storm_final": [storm["final_replicas"], storm["final_running"], storm["scale_events"]],
        **{k: storm[k] for k in STORM_EXPECTED},
        "slo_burn": slo, "gen_manifests_exit": code,
        "alert_groups": {name: [r["alert"] for r in g["rules"]] for name, g in read_back.items()},
        "alerts_probe_in_blackout": blackout_probe, "alerts_probe_final": final_probe,
        "kernel_launches": _kernel_counts(),
        "storm_s": storm_s, "storm_alerts_s": alerts_s, "slo_s": slo_s, "wall_s": wall,
    }
    emit(out)
    got = {k: rung[k] for k in CHAOS_EXPECTED}
    if got != CHAOS_EXPECTED:
        raise AssertionError(f"the fault storm differs from the JAX package's: {got}")
    got = {k: storm[k] for k in STORM_EXPECTED}
    if got != STORM_EXPECTED:
        raise AssertionError(f"the storm's trace or alerts differ from the JAX package's: {got}")
    if blackout_probe != "pipeline alerts firing: TpuAutoscaleSignalAbsent":
        raise AssertionError(f"check_alerts missed the blackout's alert: {blackout_probe}")
    got = {k: slo[k] for k in SLO_BURN_EXPECTED}
    if got != SLO_BURN_EXPECTED:
        raise AssertionError(f"the SLO check differs from the JAX package's: {got}")
    if code != 0 or set(read_back) != set(ALERT_GROUPS) or read_back != rendered:
        raise AssertionError(f"gen-manifests' alert groups differ from the generator's: {code}, "
                             f"{out['alert_groups']}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the chaos plane launched a kernel: {out['kernel_launches']}")
    return out


#: the recovery drill as the JAX package gives it (bench.py's recovery_drill
#: rung, trial.drill_rung, at a 12 s pod start on a virtual clock,
#: so exact), and the rest of the drill's result
DRILL_EXPECTED = {
    "components": ["tsdb", "hpa", "adapter", "wal"], "settled_replicas": 3,
    "mttr_s": {"tsdb_restart@30s": 0.0, "hpa_restart@210s": 0.0, "adapter_restart@390s": 0.0,
               "wal_truncate@570s": 0.0},
    "mttr_max_s": 0.0, "replay_gap_max_s": 1.0, "first_good_sync_max_s": 0.0,
    "all_recovered": True, "spurious_scale_events_during_replay": 0, "lineage_complete": True,
    "final_replicas": 4, "ok": True,
}
DRILL_RESULT_EXPECTED = {
    "final_running": 4, "scale_events": 2, "scale_event_lineages": 2, "trace_spans": 8724,
}
#: (recovered_series, recovered_points, replayed_records) at each TSDB
#: restart of the drill, the JAX package's
DRILL_RECOVERIES = [[137, 18300, 1916], [127, 45486, 2560]]
#: the kill check's durable pipeline: seconds of the drill's load, and the
#: WAL's segment and snapshot cadence (records), small so the last segment
#: is short and its tail replays fast
KILL_RUN_S = 10.0
KILL_SEGMENT = 8
KILL_SNAPSHOT_EVERY = 32
#: the checkpoint check's syncs (tests/test_recovery.py's): 40 scales to 4,
#: then 5 recommends 1, held by the 60 s window; the restart after the
#: fourth sync
CKPT_LOAD = [40.0, 40.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0]
CKPT_EXPECTED = [4, 4, 4, 4, 4, 4, 1, 1]


def _db_state(db) -> tuple:
    """What a recovery must restore: each series' points with their
    origins (a marker as None), the version counters, the stale map."""
    points = {
        (name, labels): [(t, None if v != v else v, o) for t, v, o in series.points]
        for name, by_name in db._data.items() for labels, series in by_name.items()
    }
    return points, dict(db._versions), dict(db._stale_pending)


def _kill_at_every_byte(work: Path) -> dict:
    """A durable pipeline under the drill's load for ``KILL_RUN_S``; then
    its WAL's last segment cut at every byte.  Each cut must recover, and
    to a DB equal to the snapshot fed exactly the records that landed (a
    line without its newline is the torn tail a kill leaves)."""
    clock = VirtualClock()
    cluster = SimCluster(clock, nodes=[(f"drill-node-{i}", 2) for i in range(3)],
                         pod_start_latency=trial.BASE_POD_START_LATENCY)
    dep = SimDeployment(cluster, "tpu-test", "tpu-test", load_fn=lambda t: 90.0,
                        load_mode="shared")
    cluster.add_deployment(dep, replicas=1)
    clock.advance(15.0)
    log = WriteAheadLog(work / "wal", segment_max_records=KILL_SEGMENT)
    pipe = AutoscalingPipeline(cluster, dep, target_value=40.0, max_replicas=4, wal=log,
                               checkpoint_store=FileCheckpointStore(work / "hpa.json"))
    pipe.db.snapshot_every = KILL_SNAPSHOT_EVERY
    pipe.run_for(KILL_RUN_S)
    log.close()
    payload, _ = WriteAheadLog(work / "wal").read()
    segments = sorted((work / "wal").glob("wal-*.jsonl"))
    final = segments[-1].read_bytes()
    before = [json.loads(line) for seg in segments[:-1] for line in seg.read_text().splitlines()]
    snap = work / "snapshot-only"
    only = WriteAheadLog(snap)
    only.write_snapshot(payload)
    only.close()
    references: dict[int, tuple] = {}
    cuts = 0
    for cut in range(len(final) + 1):
        segments[-1].write_bytes(final[:cut])
        recovered = TimeSeriesDB.recover(WriteAheadLog(work / "wal"), VirtualClock())
        lines = final[:cut].split(b"\n")
        landed = [json.loads(line) for line in lines[:-1] if line]
        if lines[-1]:
            try:  # a last line that parses whole landed though its newline did not
                landed.append(json.loads(lines[-1]))
            except ValueError:
                pass  # the torn last record
        if len(landed) not in references:
            reference = TimeSeriesDB.recover(WriteAheadLog(snap), VirtualClock())
            reference.wal = None
            for rec in before + landed:
                reference.append(rec["name"], tuple(map(tuple, rec["labels"])),
                                 float("nan") if rec["op"] == "stale" else rec["value"],
                                 rec["ts"], rec.get("origin"))
            references[len(landed)] = _db_state(reference)
        if _db_state(recovered) != references[len(landed)]:
            raise AssertionError(f"the WAL cut at byte {cut} of {len(final)} recovered a DB "
                                 f"other than the records that landed")
        cuts += 1
    segments[-1].write_bytes(final)
    return {"records": log.records_written, "snapshot_restored": payload is not None,
            "segments": len(segments), "final_segment_bytes": len(final), "cuts": cuts,
            "final_segment_records": len(references) - 1,
            "replayed_whole": TimeSeriesDB.recover(WriteAheadLog(work / "wal"),
                                                   VirtualClock()).last_recovery}


class _ScriptedAdapter:
    """An Object-metric adapter whose value is set before each sync."""

    def __init__(self) -> None:
        self.value = 0.0

    def get_object_metric(self, described_object, metric_name):
        return self.value


def _checkpoint_restore(work: Path) -> dict:
    """tests/test_recovery.py's restart on a checkpoint file: four syncs,
    the controller rebuilt from the file mid-window, four more: the
    recommendations of an uninterrupted controller; a cold restart scales
    down at its first sync; a torn file loads as None."""

    def controller(vclock, scripted, target, store):
        return HPAController(
            target=target,
            metrics=[ObjectMetricSpec("m", 10.0, ObjectReference("Deployment", "d", "default"),
                                      average=True)],
            adapter=scripted, clock=vclock, max_replicas=8,
            behavior=HPABehavior(scale_down=ScalingRules(stabilization_window_seconds=60.0)),
            checkpoint_store=store,
        )

    def drive(ctrl, scripted, vclock, values):
        out = []
        for v in values:
            scripted.value = v
            ctrl.sync_once()
            out.append(ctrl.target.replicas)
            vclock.advance(15.0)
        return out

    runs = {}
    for mode in ("uninterrupted", "restored", "cold"):
        vclock, scripted, target = VirtualClock(), _ScriptedAdapter(), ScaleTarget()
        store = FileCheckpointStore(work / f"{mode}.json")
        ctrl = controller(vclock, scripted, target, store)
        if mode == "uninterrupted":
            runs[mode] = drive(ctrl, scripted, vclock, CKPT_LOAD)
            continue
        first = drive(ctrl, scripted, vclock, CKPT_LOAD[:4])
        again = controller(vclock, scripted, target, store if mode == "restored" else None)
        runs[mode] = first + drive(again, scripted, vclock, CKPT_LOAD[4:])
        runs[f"{mode}_from_checkpoint"] = again.restored_from_checkpoint
    torn = work / "restored.json"
    torn.write_text(torn.read_text()[:40])
    runs["torn_loads"] = FileCheckpointStore(torn).load()
    return runs


@contextlib.contextmanager
def _timed_fsync(totals: dict):
    """Count the calls to ``os.fsync`` inside the block and the seconds
    they take (the WAL's snapshots and the HPA's checkpoint files sync)."""
    fsync = os.fsync

    def timed(fd):
        t = time.perf_counter()
        try:
            return fsync(fd)
        finally:
            totals["fsyncs"] += 1
            totals["fsync_s"] += time.perf_counter() - t

    os.fsync = timed
    try:
        yield totals
    finally:
        os.fsync = fsync


def phase_drill() -> dict:
    """Durability: the recovery drill (bench.py's recovery_drill rung), a
    WAL killed at every byte of its last segment and an HPA restored from
    its checkpoint file, on a temporary directory of this host, in virtual
    time (the module docstring, phase 43, has the bars).  The seconds spent
    in ``os.fsync`` are reported beside each part's wall time."""
    matmul_kernel.launches = 0
    _zero_counts()
    syncs = {part: {"fsyncs": 0, "fsync_s": 0.0} for part in ("drill", "kill", "checkpoint")}
    t0 = time.perf_counter()
    with _timed_fsync(syncs["drill"]):
        result = run_recovery_drill(pod_start_latency=trial.BASE_POD_START_LATENCY)
    rung = trial.drill_rung(result)
    drill_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip-smoke-durability-") as tmp:
        t1 = time.perf_counter()
        with _timed_fsync(syncs["kill"]):
            kill = _kill_at_every_byte(Path(tmp))
        kill_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        with _timed_fsync(syncs["checkpoint"]):
            ckpt = _checkpoint_restore(Path(tmp))
        ckpt_s = time.perf_counter() - t2
    recoveries = [[r["recovered_series"], r["recovered_points"], r["replayed_records"]]
                  for r in result["restarts"] if r["component"] == "tsdb"]
    wall = time.perf_counter() - t0
    out = {
        "phase": "drill", "recovery_drill": rung,
        **{k: result[k] for k in DRILL_RESULT_EXPECTED},
        "faults": result["faults"], "restarts": result["restarts"], "recoveries": recoveries,
        "kill_at_every_byte": kill, "checkpoint": ckpt, "kernel_launches": _kernel_counts(),
        "drill_s": drill_s, "kill_s": kill_s, "checkpoint_s": ckpt_s, "fsync": syncs,
        "wall_s": wall,
    }
    emit(out)
    got = {k: rung[k] for k in DRILL_EXPECTED}
    if got != DRILL_EXPECTED:
        raise AssertionError(f"the recovery drill differs from the JAX package's: {got}")
    got = {k: result[k] for k in DRILL_RESULT_EXPECTED}
    if got != DRILL_RESULT_EXPECTED:
        raise AssertionError(f"the drill's trace or scale events differ from JAX's: {got}")
    if recoveries != DRILL_RECOVERIES:
        raise AssertionError(f"the drill's TSDB restarts recovered other counts: {recoveries}")
    if not kill["snapshot_restored"] or kill["final_segment_records"] < 1:
        raise AssertionError(f"the kill check's WAL has no snapshot or no tail: {kill}")
    if (ckpt["uninterrupted"], ckpt["restored"]) != (CKPT_EXPECTED, CKPT_EXPECTED) or not (
            ckpt["restored_from_checkpoint"]) or ckpt["cold_from_checkpoint"]:
        raise AssertionError(f"the HPA restored from its checkpoint recommends otherwise: {ckpt}")
    if ckpt["cold"][4] != 1 or ckpt["torn_loads"] is not None:
        raise AssertionError(f"the cold restart kept its window or a torn file loaded: {ckpt}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the durability plane launched a kernel: {out['kernel_launches']}")
    return out


#: the metrics plane's three rungs at bench.py's smoke sizes, as the JAX
#: package gives them (bench.py's run_rung_sim_scale, run_rung_sim_scale_10k
#: and run_rung_query_bench under BENCH_TIME_SCALE below 1): every field
#: that does not read the wall clock
METRICS_SCALE_EXPECTED = {
    "sim_scale": {
        "targets": 200, "horizon_s": 600.0, "shards": 0, "peak_retained_points": 23565,
        "final_retained_points": 23565, "peak_retained_bytes": 74997,
        "bytes_per_sample": 3.183, "compression_ratio": 5.03, "total_appends": 23600,
        "series_count": 607, "fleet_vector_size": 200, "rule_full_evals": 41,
        "rule_skipped_evals": 79, "final_replicas": 5, "scale_events": 4,
    },
    "sim_scale_10k": {
        "targets": 2000, "horizon_s": 600.0, "shards": 4, "peak_retained_points": 167885,
        "final_retained_points": 167885, "peak_retained_bytes": 565585,
        "bytes_per_sample": 3.369, "compression_ratio": 4.75, "total_appends": 167920,
        "series_count": 4215, "fleet_vector_size": 2000, "rule_full_evals": 41,
        "rule_skipped_evals": 79, "final_replicas": 5, "scale_events": 4,
        "shards_disjoint": True, "shards_cover_fleet": True,
    },
    "query_bench": {
        "targets": 500, "shards": 4, "horizon_s": 1800.0, "window_s": 1500.0,
        "retained_points": 180001, "identical": True, "planner_fastpath": 8000,
        "planner_fallback": 2000, "series_cache_hits": 276, "series_resolves": 14,
        "plans_built": 7, "decode_cache_hits": 0, "decode_cache_misses": 12000,
    },
}
#: the wall-clock fields each rung prints beside its bars
METRICS_SCALE_WALL = ("wall_s", "speedup", "speedup_floor", "meets_floor", "query_p50_ms",
                      "query_p95_ms", "appends_per_sec", "naive_ms", "planned_ms", "exprs",
                      "federated_scan_p95_ms", "ok")


def phase_metrics_scale() -> dict:
    """The metrics plane at scale: bench.py's sim_scale, sim_scale_10k and
    query_bench rungs at their smoke sizes, on the host and virtual clocks
    (the module docstring, phase 44, has the bars).  Each rung's
    deterministic fields are held to the JAX package's, its speedup to its
    floor; the fleet query's p95 and the appends rate are reported beside
    their perfgates bars."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    rungs, calls = {}, {}
    for name, rung in (("sim_scale", trial.sim_scale_rung),
                       ("sim_scale_10k", trial.sim_scale_10k_rung),
                       ("query_bench", trial.query_bench_rung)):
        t = time.perf_counter()
        rungs[name] = rung()
        calls[name] = time.perf_counter() - t
    out = {"phase": "metrics_scale", "kernel_launches": _kernel_counts()}
    for name, result in rungs.items():
        got = {k: result[k] for k in METRICS_SCALE_EXPECTED[name]}
        wall = {k: result[k] for k in METRICS_SCALE_WALL if k in result}
        wall["call_s"] = calls[name]
        wall["query_p95_budget_ms"] = perfgates.MAX_FLEET_QUERY_P95_MS
        wall["meets_p95_budget"] = result["query_p95_ms"] <= perfgates.MAX_FLEET_QUERY_P95_MS
        if "appends_per_sec" in result:
            wall["appends_per_sec_floor"] = perfgates.MIN_APPENDS_PER_SEC
            wall["meets_appends_floor"] = (
                result["appends_per_sec"] >= perfgates.MIN_APPENDS_PER_SEC)
        out[name] = {"deterministic": got, "matches_jax": got == METRICS_SCALE_EXPECTED[name],
                     **wall}
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    for name in rungs:
        if not out[name]["matches_jax"]:
            raise AssertionError(f"{name} differs from the JAX package's: "
                                 f"{out[name]['deterministic']}")
        if not out[name]["meets_floor"]:
            raise AssertionError(f"{name}'s speedup {out[name]['speedup']} is under its "
                                 f"floor {out[name]['speedup_floor']}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the metrics plane launched a kernel: {out['kernel_launches']}")
    return out


#: the rollup phase's deterministic fields as the JAX package gives them:
#: bench.py's run_rung_downsample_bench at its smoke size, and simulate's
#: run_history(days=0.125) with run_why on its first scale event
ROLLUPS_EXPECTED = {
    "downsample_bench": {
        "appended_points": 144000, "retained_points": 144000, "fleet_series": 200,
        "identical": True, "rollup_reads": {"1h": 2}, "tier_selected": True,
        "aged_points": 128000, "rollup_bytes": 169245, "bytes_ratio": 0.0826,
        "tiers": {"5m": {"series": 200, "chunks": 0, "buckets": 12600, "bytes": 147960},
                  "1h": {"series": 200, "chunks": 0, "buckets": 1000, "bytes": 21285}},
        "differential": {"windows_checked": 50, "fold_mismatches": 0, "row_mismatches": 0,
                         "identical": True},
    },
    "history": {
        "ok": True, "violations": [],
        "scale_events": [
            {"span_id": 516, "t": 1560.0, "from": 1, "to": 2, "complete": True},
            {"span_id": 1378, "t": 4380.0, "from": 2, "to": 3, "complete": True},
            {"span_id": 2368, "t": 7380.0, "from": 3, "to": 4, "complete": True},
        ],
        "fault_windows": [
            {"t0": 3240.0, "t1": 3900.0, "fault": "exporter_outage@3240s",
             "kind": "exporter_outage"},
            {"t0": 6480.0, "t1": 6480.0, "fault": "tsdb_restart@6480s", "kind": "tsdb_restart"},
        ],
        "restarts": [{"component": "tsdb", "t": 6480.0}],
        "hours": {
            1: {"signal": 30.846835426606866, "replicas_avg": 1.5714285714285714,
                "replicas_max": 2.0, "duty": 0.5714285714285714, "slo_bad": 36.0},
            2: {"signal": 37.52585496514544, "replicas_avg": 2.783333333333333,
                "replicas_max": 3.0, "duty": 1.0, "slo_bad": 25.0},
            3: {"signal": None, "replicas_avg": None, "replicas_max": None, "duty": 1.0,
                "slo_bad": 0.0},
        },
        "tier_buckets": {"5m": 5218, "1h": 327},
        "tier_reads": {"raw": 5052},
    },
    "why": {"ok": True, "complete": True, "event": {"span_id": 516, "t": 1560.0, "from": 1, "to": 2},
            "hops": ["scale_event", "hpa_sync", "adapter_query", "rule_eval", "scrape",
                     "exporter_sample"]},
}
#: the history's tier bytes over the JAX package's runs on a CPU: they roll
#: up the pipeline's self-metrics, which record wall-clock durations
HISTORY_TIER_BYTES_JAX = {"5m": (69679, 69756), "1h": (11228, 11231)}
HISTORY_DAYS = 0.125


def phase_rollups() -> dict:
    """The rollup tiers and the flight recorder: bench.py's downsample_bench
    rung at its smoke size, the history scenario at 0.125 virtual days and
    why on its first scale event, on the host and virtual clocks (the
    module docstring, phase 45, has the bars)."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    bench = trial.downsample_bench_rung()
    bench_s = time.perf_counter() - t0
    t = time.perf_counter()
    hist = simulate.run_history(days=HISTORY_DAYS)
    history_s = time.perf_counter() - t
    t = time.perf_counter()
    why = simulate.run_why(hist["scale_events"][0]["span_id"], history=hist)
    unknown = simulate.run_why(10 ** 9, history=hist)
    why_s = time.perf_counter() - t
    got = {
        "downsample_bench": {k: bench[k] for k in ROLLUPS_EXPECTED["downsample_bench"]},
        "history": {
            **{k: hist[k] for k in ROLLUPS_EXPECTED["history"]
               if k not in ("tier_buckets",)},
            "tier_buckets": {label: t["buckets"]
                             for label, t in hist["tier_stats"]["tiers"].items()},
        },
        "why": {"ok": why["ok"], "complete": why["complete"], "event": why["event"],
                "hops": [h["kind"] for h in why["hops"]]},
    }
    tier_bytes = {label: t["bytes"] for label, t in hist["tier_stats"]["tiers"].items()}
    out = {
        "phase": "rollups", "kernel_launches": _kernel_counts(),
        "matches_jax": {name: got[name] == want for name, want in ROLLUPS_EXPECTED.items()},
        "downsample_bench": {
            "speedup": bench["speedup"], "speedup_floor": bench["speedup_floor"],
            "meets_floor": bench["meets_floor"], "bytes_ratio": bench["bytes_ratio"],
            "bytes_ratio_budget": bench["bytes_ratio_budget"], "ok": bench["ok"],
            "populate_s": bench["populate_s"], "appends_per_sec": bench["appends_per_sec"],
            "rollup_ms": bench["rollup_ms"], "raw_ms": bench["raw_ms"], "call_s": bench_s,
        },
        "history": {
            "days": HISTORY_DAYS, "call_s": history_s, "tier_bytes": tier_bytes,
            "tier_bytes_jax_range": HISTORY_TIER_BYTES_JAX,
            "tier_bytes_in_jax_range": {
                label: lo <= tier_bytes.get(label, -1) <= hi
                for label, (lo, hi) in HISTORY_TIER_BYTES_JAX.items()},
            "scale_events": [e["span_id"] for e in hist["scale_events"]],
        },
        "why": {"call_s": why_s, "event": why["event"]["span_id"],
                "hops": got["why"]["hops"], "unknown_id_ok": unknown["ok"],
                "unknown_id_error": unknown.get("error")},
    }
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    for name, same in out["matches_jax"].items():
        if not same:
            raise AssertionError(f"{name} differs from the JAX package's: {got[name]}")
    if not bench["meets_floor"]:
        raise AssertionError(f"downsample_bench's speedup {bench['speedup']} is under its floor "
                             f"{bench['speedup_floor']}")
    if bench["bytes_ratio"] > perfgates.MAX_ROLLUP_BYTES_RATIO:
        raise AssertionError(f"downsample_bench's bytes ratio {bench['bytes_ratio']} is over "
                             f"{perfgates.MAX_ROLLUP_BYTES_RATIO}")
    if unknown["ok"]:
        raise AssertionError("why accepted an unknown scale-event id")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the rollup plane launched a kernel: {out['kernel_launches']}")
    return out


#: the crunch's deterministic fields as the JAX package gives them
#: (run_capacity_crunch() on a CPU), and the SHA-256 of its whole result as
#: sorted JSON (9388 bytes: these fields, the fault reports and the
#: scheduler's 51 events)
CRUNCH_EXPECTED = {
    "ok": True, "violations": [], "all_recovered": True, "preemptions_total": 3,
    "settled": {"tpu-prod": 1, "tpu-batch": 1, "tpu-best": 1},
    "pool": {"capacity_final": 16, "used_final": 7, "audit_ticks": 224, "conserved_all": True,
             "audit_violations": []},
    "autoscaler": {"provisions": 2, "provision_failures": 1, "nodes_final": 0,
                   "reaped": ["tpu-auto-0", "tpu-auto-1"]},
    "tenants": {
        "tpu-prod": {"priority": 100, "weight": 2.0, "chips_per_pod": 4, "preemption_budget": 0,
                     "starvation_budget_s": 120.0, "ttc_gate_s": 60.0, "admissions": 5,
                     "ttc_p95_s": 10.0, "max_pending_stint_s": 10.0, "pending_seconds": 10.0,
                     "preemptions_suffered": 0, "final_replicas": 1, "final_running": 1,
                     "final_pending": 0, "final_terminating": 0, "scale_events": 3},
        "tpu-batch": {"priority": 10, "weight": 1.0, "chips_per_pod": 2, "preemption_budget": 6,
                      "starvation_budget_s": 600.0, "ttc_gate_s": 480.0, "admissions": 7,
                      "ttc_p95_s": 310.0, "max_pending_stint_s": 310.0,
                      "pending_seconds": 1300.0, "preemptions_suffered": 1, "final_replicas": 1,
                      "final_running": 1, "final_pending": 0, "final_terminating": 0,
                      "scale_events": 3},
        "tpu-best": {"priority": 10, "weight": 0.5, "chips_per_pod": 1, "preemption_budget": 10,
                     "starvation_budget_s": 900.0, "ttc_gate_s": 480.0, "admissions": 8,
                     "ttc_p95_s": 235.0, "max_pending_stint_s": 235.0, "pending_seconds": 1350.0,
                     "preemptions_suffered": 2, "final_replicas": 1, "final_running": 1,
                     "final_pending": 0, "final_terminating": 0, "scale_events": 6},
    },
    "event_counts": {"admitted": 17, "pending": 15, "provision_requested": 3, "preempted": 3,
                     "evicted": 3, "readmitted": 3, "fair_share_limited": 2, "provisioned": 2,
                     "node_reaped": 2, "provision_failed": 1},
}
CRUNCH_SHA256 = "1eeeb79e0c0250714a51e732213936eb5a3c01b90a2a747e7e9f9367b150726b"
#: capacity_selfcheck()'s fields and the doctor's verdict on it, as the JAX
#: package gives them
SELFCHECK_EXPECTED = {"ticks": 70, "conserved_all": True, "violations": [],
                      "preemption_roundtrip": True, "lo_running": 1, "hi_running": 1,
                      "preemptions_total": 1, "events": 10}
SELFCHECK_VERDICT = "pool conserved over 70 tick(s), 1 preemption(s) round-tripped to Running"


class FakeKubeAPI:
    """The few API-server paths the quantum operator speaks, on 127.0.0.1:
    the namespace's HPAs, each target's scale subresource (GET and merge
    PATCH) and a coordination.k8s.io Lease (absent until POSTed; a PATCH
    with a stale resourceVersion gets 409).  ``patches`` logs each scale
    PATCH as (target, replicas)."""

    def __init__(self, hpas: list[dict], scales: dict[str, int]):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.hpas, self.scales = hpas, scales
        self.lease: dict | None = None
        self.patches: list[tuple[str, int]] = []
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, doc: dict | None = None) -> None:
                body = json.dumps(doc or {}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                return json.loads(self.rfile.read(int(self.headers["Content-Length"])))

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if parts[-1] == "horizontalpodautoscalers":
                    return self._send(200, {"items": api.hpas})
                if parts[-1] == "scale" and parts[-2] in api.scales:
                    return self._send(200, {"spec": {"replicas": api.scales[parts[-2]]}})
                if "leases" in parts and api.lease is not None:
                    return self._send(200, api.lease)
                return self._send(404)

            def do_POST(self):
                if api.lease is not None:
                    return self._send(409)
                api.lease = {**self._body(), "metadata": {"name": "quantum-operator",
                                                          "resourceVersion": "1"}}
                return self._send(201, api.lease)

            def do_PATCH(self):
                parts, body = self.path.strip("/").split("/"), self._body()
                if parts[-1] == "scale":
                    api.scales[parts[-2]] = body["spec"]["replicas"]
                    api.patches.append((parts[-2], body["spec"]["replicas"]))
                    return self._send(200, {"spec": {"replicas": api.scales[parts[-2]]}})
                rv = api.lease["metadata"]["resourceVersion"]
                if body.get("metadata", {}).get("resourceVersion") != rv:
                    return self._send(409)
                api.lease["spec"].update(body["spec"])
                api.lease["metadata"]["resourceVersion"] = str(int(rv) + 1)
                return self._send(200, api.lease)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, args=(0.05,),
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _slice_hpa(name: str, desired: int) -> dict:
    """A slice HPA on StatefulSet ``name``: quantum 4, replicas 4..16."""
    return {"metadata": {"name": name, "annotations": {QUANTUM_ANNOTATION: "4"}},
            "spec": {"scaleTargetRef": {"kind": "StatefulSet", "name": name},
                     "minReplicas": 4, "maxReplicas": 16},
            "status": {"desiredReplicas": desired}}


def _get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _operator_run() -> dict:
    """The slice-quantum operator against FakeKubeAPI, with its Lease and
    its health server on 127.0.0.1: a growing partial slice (5 pods, the
    HPA wanting 6) rounded up to 8 and a steady one (6 and 6) held, whose
    gauge the doctor must report; then the held HPA grows (7), the operator
    rounds it up too, and the doctor passes."""
    api = FakeKubeAPI([_slice_hpa("slice-grow", 6), _slice_hpa("slice-steady", 6),
                       {"metadata": {"name": "plain"}, "spec": {}}],
                      {"slice-grow": 5, "slice-steady": 6})
    client = KubeClient(api_base=api.url, token="smoke")
    op = QuantumOperator(client, elector=LeaseElector(client, "default", identity="smoke"))
    health = start_health_server(op, 0, host="127.0.0.1")
    base = f"http://127.0.0.1:{health.server_port}"
    try:
        first = op.tick()
        op.last_tick = time.monotonic()
        probes = {path: _get(base + path)[0] for path in ("/healthz", "/readyz", "/nope")}
        held_text = _get(base + "/metrics")[1]
        try:
            held_verdict = check_operator_metrics(held_text)
            held_refused = False
        except AssertionError as e:
            held_verdict, held_refused = str(e), True
        api.hpas[1]["status"]["desiredReplicas"] = 7
        second = op.tick()
        clear_text = _get(base + "/metrics")[1]
        clear_verdict = check_operator_metrics(clear_text)
    finally:
        health.shutdown()
        health.server_close()
        api.close()
    return {
        "repairs": [[a.target, a.from_replicas, a.to_replicas] for a in first + second],
        "patches": [list(p) for p in api.patches], "leader": op.elector.is_leader,
        "lease_holder": (api.lease or {}).get("spec", {}).get("holderIdentity"),
        "probes": probes, "held_refused": held_refused, "held_verdict": held_verdict,
        "clear_verdict": clear_verdict,
        "metrics": {f.name: [s.value for s in f.samples] for f in parse_text(clear_text)},
    }


#: what the operator run must give: each repair, the PATCHes in order, the
#: probes' codes and the doctor's two verdicts
OPERATOR_EXPECTED = {
    "repairs": [["StatefulSet/slice-grow", 5, 8], ["StatefulSet/slice-steady", 6, 8]],
    "patches": [["slice-grow", 8], ["slice-steady", 8]], "leader": True, "lease_holder": "smoke",
    "probes": {"/healthz": 200, "/readyz": 200, "/nope": 404}, "held_refused": True,
    "held_verdict": "partial slice held on StatefulSet/slice-steady: stranded hosts are running "
                    "but serving nothing — make the HPA's minReplicas/maxReplicas slice multiples",
    "clear_verdict": "operator alive (2 reconcile passes), no partial slice held",
    "metrics": {"quantum_operator_reconciles_total": [2.0],
                "quantum_operator_repairs_total": [0.0, 2.0],
                "quantum_operator_suppressed_repairs_total": [0.0],
                "quantum_operator_lease_transitions_total": [0.0],
                "quantum_operator_partial_slice_held": [0.0, 0.0]},
}


def phase_capacity() -> dict:
    """The capacity economy and the slice-quantum operator, in this process
    on virtual clocks and 127.0.0.1 (the module docstring, phase 46, has the
    bars).  The crunch runs under a coverage map and a profile map, which
    the returned dict carries to phase_coverage under ``maps``."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    with coverage.collect("crunch") as cmap, profile.collect("crunch") as pmap:
        crunch = run_capacity_crunch()
    crunch_s = time.perf_counter() - t0
    digest = hashlib.sha256(json.dumps(crunch, sort_keys=True).encode()).hexdigest()
    events: dict[str, int] = {}
    for e in crunch["events"]:
        events[e["event"]] = events.get(e["event"], 0) + 1
    got = {k: crunch[k] for k in CRUNCH_EXPECTED if k != "event_counts"}
    got["event_counts"] = events
    t = time.perf_counter()
    selfcheck = capacity_selfcheck()
    verdict = check_capacity_pool(json.dumps(selfcheck))
    selfcheck_s = time.perf_counter() - t
    t = time.perf_counter()
    operator = _operator_run()
    operator_s = time.perf_counter() - t
    out = {
        "phase": "capacity", "kernel_launches": _kernel_counts(),
        "crunch": {"call_s": crunch_s, "sha256": digest, "bytes": len(json.dumps(crunch, sort_keys=True)),
                   "matches_jax": {k: got[k] == want for k, want in CRUNCH_EXPECTED.items()},
                   "sha256_matches_jax": digest == CRUNCH_SHA256,
                   "ttc_p95_s": {n: t["ttc_p95_s"] for n, t in crunch["tenants"].items()}},
        "selfcheck": {"call_s": selfcheck_s, "verdict": verdict,
                      "fields": {**{k: v for k, v in selfcheck.items() if k != "events"},
                                 "events": len(selfcheck["events"])}},
        "operator": {"call_s": operator_s, **operator},
    }
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    for key, same in out["crunch"]["matches_jax"].items():
        if not same:
            raise AssertionError(f"the crunch's {key} differs from the JAX package's: {got[key]}")
    if digest != CRUNCH_SHA256:
        raise AssertionError(f"the crunch's result differs from the JAX package's: {digest}")
    if out["selfcheck"]["fields"] != SELFCHECK_EXPECTED or verdict != SELFCHECK_VERDICT:
        raise AssertionError(f"capacity_selfcheck differs from the JAX package's: {out['selfcheck']}")
    for key, want in OPERATOR_EXPECTED.items():
        if operator[key] != want:
            raise AssertionError(f"the operator's {key} is {operator[key]!r}, not {want!r}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the capacity plane launched a kernel: {out['kernel_launches']}")
    out["maps"] = {"coverage": cmap, "profile": pmap, "wall_s": crunch_s}
    return out


#: the region evacuation's runs as the JAX package gives them
#: (run_region_evacuation() on a CPU): evacuation_fingerprint, and the
#: SHA-256 of the whole result as sorted JSON with ``objstore.bytes`` left
#: out (the object store's byte count follows PYTHONHASHSEED in both
#: packages, and is printed beside JAX's range instead)
EVAC_EXPECTED = {
    "full": {"fingerprint": "crc32:38f93eee",
             "sha256": "9ba0e4b9f7ee92275f20a4219c4a4b9043b71f403652eb92432f9f186cea49ee",
             "ok": True, "violations": 0},
    "canary": {"fingerprint": "crc32:4c4c8bae",
               "sha256": "7c45d1764e40c8f148544c340faba258423646dc49fabeb6427b86c55555ad04",
               "ok": False, "violations": 5},
}
#: the least and most ``objstore.bytes`` the JAX package's runs gave under
#: PYTHONHASHSEED 0-3 on a CPU
EVAC_JAX_BYTES = {"full": [13970478, 13970485], "canary": [8195148, 8195150]}


def _evac_sha256(result: dict) -> str:
    rest = {**result, "objstore": {k: v for k, v in result["objstore"].items() if k != "bytes"}}
    return hashlib.sha256(json.dumps(rest, sort_keys=True).encode()).hexdigest()


def phase_evacuate() -> dict:
    """The region evacuation, in this process on a virtual clock:
    ``trial.evacuation_rung`` (bench.py's region_evacuation rung) of the
    full run and the smoke canary, each run timed, fingerprinted and hashed
    against the JAX package's (EVAC_EXPECTED); the rung's ``ok`` must hold
    (the run keeps the contract, the canary breaks it), and no kernel is
    launched."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    runs, out = {}, {"phase": "evacuate"}
    for name, kw in (("full", {}), ("canary", {"spill_enabled": False, "smoke": True})):
        t = time.perf_counter()
        runs[name] = run_region_evacuation(**kw)
        out[name] = {"call_s": time.perf_counter() - t,
                     "fingerprint": evacuation_fingerprint(runs[name]),
                     "sha256": _evac_sha256(runs[name]), "ok": runs[name]["ok"],
                     "violations": len(runs[name]["violations"]),
                     "objstore_bytes": runs[name]["objstore"]["bytes"],
                     "jax_objstore_bytes": EVAC_JAX_BYTES[name]}
    rung = trial.evacuation_rung(runs["full"], runs["canary"])
    out["rung"] = {k: rung[k] for k in ("ok", "ttc_s", "spills_admitted", "spills_denied",
                                        "generations", "bit_identical", "canary_failed",
                                        "canary_violations")}
    out["kernel_launches"] = _kernel_counts()
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    for name, want in EVAC_EXPECTED.items():
        got = {k: out[name][k] for k in want}
        if got != want:
            raise AssertionError(f"the evacuation's {name} run differs from the JAX package's: {got}")
    if not rung["ok"]:
        raise AssertionError(f"the region_evacuation rung failed: {rung}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the evacuation launched a kernel: {out['kernel_launches']}")
    return out


#: SHA-256 of each export as the JAX package gives it on a CPU: the
#: crunch's CoverageMap.export_json() and ProfileMap.export_json() (its
#: canonical export), run_coverage("profile")'s export as export_json()
#: gives it, and run_profile("scale", smoke=True)'s canonical export
COVERAGE_EXPECTED = {
    "crunch_coverage": "d2204e144e2067d91de1f3e47a036e0019179009f274d917b88643f8f3da9065",
    "crunch_profile": "179a4e96e5ab6a5e29f3b73f9a0b6ba4e076fab554ba1d2f2a78a9c4c0f9a2b0",
    "profile_coverage": "92675d984010bbf244e65590aacdcc95505cfcc4708a8786e24b1c4a9a644a6f",
    "scale_profile": "324b379db7ec181d1aabc89782fc5b384342912453081049a0894422e61f618f",
}


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def phase_coverage(maps: dict) -> dict:
    """The simulator's self-observability, in this process on virtual
    clocks: the crunch's two maps from phase_capacity (``maps``), the
    ``coverage --run profile`` session and the smoke scale run profiled,
    each export hashed against the JAX package's (COVERAGE_EXPECTED), the
    scale run's attribution against its floor, and no kernel launched."""
    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    cmap, pmap = maps["coverage"], maps["profile"]
    crunch_timed = pmap.timed_export(maps["wall_s"])
    out = {"phase": "coverage",
           "crunch_coverage": {"sha256": _sha256(cmap.export_json()),
                               "probes_hit": cmap.hit_count(), "call_s": maps["wall_s"]},
           "crunch_profile": {"sha256": _sha256(pmap.export_json()),
                              "paths": len(crunch_timed["paths"]),
                              "attribution": crunch_timed["attribution"],
                              "open_spans": pmap.open_spans(), "call_s": maps["wall_s"]}}
    t = time.perf_counter()
    export = simulate.run_coverage("profile")
    out["profile_coverage"] = {
        "sha256": _sha256(json.dumps(export, sort_keys=True, separators=(",", ":"))),
        "probes_hit": sum(1 for rec in export["probes"].values() if rec["count"]),
        "call_s": time.perf_counter() - t}
    t = time.perf_counter()
    scale = run_profile("scale", smoke=True)[0]
    out["scale_profile"] = {"sha256": _sha256(scale["canonical"]),
                            "paths": len(scale["export"]["paths"]),
                            "attribution": scale["attribution"],
                            "attribution_floor": perfgates.PROFILE_MIN_ATTRIBUTION,
                            "attribution_ok": scale["attribution_ok"],
                            "open_spans": scale["open_spans"], "measured_wall_s": scale["wall_s"],
                            "call_s": time.perf_counter() - t}
    out["kernel_launches"] = _kernel_counts()
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    for name, want in COVERAGE_EXPECTED.items():
        if out[name]["sha256"] != want:
            raise AssertionError(f"the {name} export differs from the JAX package's: {out[name]}")
    for name in ("crunch_profile", "scale_profile"):
        if out[name]["open_spans"]:
            raise AssertionError(f"the {name} run left spans open: {out[name]['open_spans']}")
    if not scale["attribution_ok"] or scale["attribution"] < perfgates.PROFILE_MIN_ATTRIBUTION:
        raise AssertionError(f"the scale run's attribution is under its floor: {out['scale_profile']}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the coverage phase launched a kernel: {out['kernel_launches']}")
    return out


#: SHA-256 of the canonical JSON (sorted keys, no whitespace) of
#: run_coverage("incident")'s export and of the smoke evacuation paging
#: drill with --break-inhibition armed, as the JAX package gives them on a
#: CPU (the canary's under PYTHONHASHSEED 0-3 alike)
INCIDENT_EXPECTED = {
    "coverage_incident": "e64655f27fced2bd8eddc8ab928d41927f83bff3d4bb2a26f489ab6a364bc4a8",
    "evacuate_canary": "499c82b9639958a407584727744bc90e04522788c9892340cbecc2f2bb1db324",
}
#: the committed fuzz artifacts the phase replays (tests/scenarios/; the
#: evac-*.json files there are evacuation artifacts, not fuzz ones)
INCIDENT_REPLAYS = ("break-grace-canary", "overlap-stress")


def phase_incident() -> dict:
    """The adversarial and paging planes, in this process on virtual
    clocks: the ``coverage --run incident`` session (a smoke evacuation
    paging drill and the router's and correlator's edges), the
    mis-inhibition canary (the smoke evacuation drill with
    --break-inhibition) and a replay of each committed fuzz artifact.  The
    session's export and the canary's result hash to the JAX package's
    (INCIDENT_EXPECTED), the canary breaks the paging contract with an
    uninhibited duplicate page, each replay reproduces its recorded
    fingerprint and violations, and no kernel is launched."""
    def digest(obj) -> str:
        return _sha256(json.dumps(obj, sort_keys=True, separators=(",", ":")))

    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    out = {"phase": "incident"}
    t = time.perf_counter()
    export = simulate.run_coverage("incident")
    out["coverage_incident"] = {
        "sha256": digest(export),
        "probes_hit": sum(1 for rec in export["probes"].values() if rec["count"]),
        "call_s": time.perf_counter() - t}
    t = time.perf_counter()
    canary = run_paging_evacuation(smoke=True, break_inhibition=True)
    out["evacuate_canary"] = {
        "sha256": digest(canary),
        "pages": canary["score"]["pages_total"], "ok": canary["ok"],
        "violations": sorted({v["kind"] for v in canary["score"]["violations"]}),
        "call_s": time.perf_counter() - t}
    scenarios = Path(__file__).resolve().parent / "tests" / "scenarios"
    out["replays"] = {}
    for name in INCIDENT_REPLAYS:
        t = time.perf_counter()
        replay = replay_artifact(scenarios / f"{name}.json")
        out["replays"][name] = {
            "sha256": digest(replay),
            **{k: replay[k] for k in ("ok", "fingerprint_match", "violations_match")},
            "violations": len(replay["violations"]), "call_s": time.perf_counter() - t}
    out["kernel_launches"] = _kernel_counts()
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    for name, want in INCIDENT_EXPECTED.items():
        if out[name]["sha256"] != want:
            raise AssertionError(f"the {name} run differs from the JAX package's: {out[name]}")
    if canary["ok"] or "uninhibited_duplicate_page" not in out["evacuate_canary"]["violations"]:
        raise AssertionError(f"the mis-inhibition canary was not caught: {out['evacuate_canary']}")
    for name, replay in out["replays"].items():
        if not (replay["ok"] and replay["fingerprint_match"] and replay["violations_match"]):
            raise AssertionError(f"the fuzz artifact {name} did not replay: {replay}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the incident phase launched a kernel: {out['kernel_launches']}")
    return out


#: SHA-256 of the canonical JSON of the JAX package's race sweep at its
#: defaults, of its break-ordering canary at seed 7 and of its
#: run_coverage("races") export, on the CPU (the same under PYTHONHASHSEED
#: 0, 1 and 2)
RACES_EXPECTED = {
    "race_sweep": "853c79276f4488469c6804b0058c179bfea0b7abc10b41b7a110cbe019470892",
    "race_canary": "380e64dab38abc52fd66ccc73314533eb3e79eb7e4c66e90f5f860db7ce957cb",
    "coverage_races": "da406d54d6b317cba7263a1dc7ad8c08be4c2e233c784ffa671af371538668af",
}


def phase_races() -> dict:
    """The race harness and the static-analysis gate, in this process on the
    host: run_race_sweep() (a serial reference, four seeded permutations of
    the shard-rules fan-out and one run on a real ThreadPoolExecutor, the
    coverage map's inferred lockset armed), its break-ordering canary at
    seed 7, simulate.run_coverage("races") and analysis.run_passes() over
    this checkout.  The sweep, the canary and the export hash to the JAX
    package's (RACES_EXPECTED), the sweep passes and the canary diverges,
    the gate is ok with no stale allowlist entry, and no kernel is
    launched."""
    def digest(obj) -> str:
        return _sha256(json.dumps(obj, sort_keys=True, separators=(",", ":")))

    matmul_kernel.launches = 0
    _zero_counts()
    t0 = time.perf_counter()
    out = {"phase": "races"}
    t = time.perf_counter()
    sweep = run_race_sweep()
    out["race_sweep"] = {"sha256": digest(sweep), "ok": sweep["ok"],
                         "serial": sweep["serial_fingerprint"][:16],
                         "threads_match": sweep["threads"]["match"],
                         "call_s": time.perf_counter() - t}
    t = time.perf_counter()
    canary = run_race_sweep(seed=7, break_ordering=True)
    out["race_canary"] = {"sha256": digest(canary), "ok": canary["ok"],
                          "divergent": canary["divergent"], "call_s": time.perf_counter() - t}
    t = time.perf_counter()
    export = simulate.run_coverage("races")
    out["coverage_races"] = {"sha256": digest(export),
                             "concurrency": export["domains"]["concurrency"],
                             "call_s": time.perf_counter() - t}
    t = time.perf_counter()
    report = analysis.run_passes()
    out["analysis"] = {"ok": report.ok, "passes": len(report.passes),
                       "findings": [f.render() for f in report.findings],
                       "allowed": len(report.allowed), "wall_s": time.perf_counter() - t}
    out["kernel_launches"] = _kernel_counts()
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    for name, want in RACES_EXPECTED.items():
        if out[name]["sha256"] != want:
            raise AssertionError(f"the {name} run differs from the JAX package's: {out[name]}")
    if not sweep["ok"]:
        raise AssertionError(f"a schedule diverged from the serial reference: {out['race_sweep']}")
    if canary["ok"]:
        raise AssertionError(f"the break-ordering canary was not caught: {out['race_canary']}")
    if not report.ok:
        raise AssertionError(f"the static-analysis gate failed: {out['analysis']['findings']}")
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the races phase launched a kernel: {out['kernel_launches']}")
    return out


def _descendants(pid: int) -> list[str]:
    """The processes below ``pid`` that have not exited (zombies aside),
    as ``pid state command``."""
    procs = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:  # exited meanwhile
            continue
        name, fields = text[text.index("(") + 1:text.rindex(")")], text[text.rindex(")") + 2:].split()
        procs[int(stat.parent.name)] = (int(fields[1]), fields[0], name)
    below, found = {pid}, True
    while found:
        found = False
        for child, (parent, _, _) in procs.items():
            if parent in below and child not in below:
                below.add(child)
                found = True
    return [f"{p} {procs[p][1]} {procs[p][2]}" for p in sorted(below - {pid})
            if procs[p][1] != "Z"]


def phase_processes() -> dict:
    """Every process this script started has ended: the container commands'
    and the ranks', and the fork server the ranks came from (stopped here,
    as it would be at exit)."""
    stop_rank_server()
    out = {"phase": "processes", "left": _descendants(os.getpid())}
    emit(out)
    if out["left"]:
        raise AssertionError(f"processes this script started still run: {out['left']}")
    return out


def phase_host_only() -> None:
    """The host-only phases in turn (virtual time, no kernel, the JAX
    package's numbers as their bars), then a check that no process they
    started still runs.  ``main`` runs this in a process of its own beside
    the headline loop (``_host_only_start``)."""
    phase_trace()
    phase_chaos()
    phase_drill()
    phase_metrics_scale()
    phase_rollups()
    capacity = phase_capacity()
    phase_evacuate()
    phase_coverage(capacity["maps"])
    phase_incident()
    phase_races()
    stop_rank_server()
    left = _descendants(os.getpid())
    if left:
        raise AssertionError(f"processes the host-only phases started still run: {left}")


def _host_only_start(log: Path) -> subprocess.Popen:
    """``phase_host_only`` in a process of its own, its lines (their ``t_s``
    on this process's clock) into ``log``.  They launch no kernel and leave
    the device idle, and the headline loop leaves the host's cores idle
    while it waits on its syncs, so the two run side by side; the process
    is killed at exit if it is still running."""
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke as c; c._START = {_START!r}; c.phase_host_only()"],
            cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT,
            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def _host_only_finish(proc: subprocess.Popen, log: Path) -> None:
    """Waits for the host-only phases, prints their lines, and fails where
    they failed."""
    code = proc.wait(timeout=900)
    with _EMIT_LOCK:
        sys.stdout.write(log.read_text())
        sys.stdout.flush()
    if code != 0:
        raise AssertionError(f"the host-only phases failed with exit code {code}")


def main() -> int:
    global _START
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 1
    _START = time.perf_counter()
    torch.cuda.set_device(0)
    device = phase_device()
    peak_gbps = device["peak_hbm_gbps"]
    phase_build()
    max_err = phase_parity()
    timing = phase_timing(peak_gbps)
    host_dir = tempfile.TemporaryDirectory()
    host_log = Path(host_dir.name) / "host_only.log"
    with tempfile.TemporaryDirectory() as knob_dir:
        gen, dwell_mfu_pct = phase_loadgen(knob_dir)
        phase_profile(gen)
        host_only = _host_only_start(host_log)
        launches, loop_scale_up_s = phase_loop(gen)
        launches += phase_overshoot(gen)
        attribution = phase_nvml(gen)
        launches += phase_node_loop(gen, attribution)
    del gen
    flash_err = phase_flash_parity()
    flash_timing = phase_flash_timing(peak_gbps)
    phase_dwell(device)
    serve = DecodeLoadGen(**SERVE_SIZES, window=3.0, device="cuda:0")
    serve.warmup()
    phase_serve_parity(serve)
    serve_saturated_pct = phase_serve_loadgen(serve)["saturated_signal_pct"]
    phase_serve_profile(serve)
    flash_launches, serve_scale_up_s = phase_serve_loop(serve)
    del serve
    bwd_err = phase_flash_bwd_parity()
    bwd_timing = phase_flash_bwd_timing(peak_gbps)
    gens, parity_counts = phase_llm_parity()
    train_counts = phase_llm_train(gens)
    phase_llm_profile(gens["auto"])
    del gens
    torch.cuda.empty_cache()
    head256 = phase_head256()
    torch.cuda.empty_cache()
    wide = phase_head_wide()
    torch.cuda.empty_cache()
    dtypes = phase_dtypes()
    torch.cuda.empty_cache()
    streamed = phase_head1024()
    torch.cuda.empty_cache()
    phase_train_parity()
    train_gen, _ = phase_train_loadgen()
    phase_train_profile(train_gen)
    phase_train_loop(train_gen)
    del train_gen
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        # the two training commands at once: neither has a rate bar, and
        # each checks only its own reports, save and resume
        with ThreadPoolExecutor(2) as pool:
            entries = [pool.submit(phase_train_entry, work_dir),
                       pool.submit(phase_llm_entry, work_dir)]
        for done in entries:
            done.result()
        mesh = phase_mesh()
        phase_tp_mlp(mesh)
        phase_allreduce_loadgen()
        phase_ringattn_loadgen()
        phase_moe_loadgen()
        _, tp_launches = phase_tp_serve_graph()
        phase_slice_loop()
        phase_slice_nvml()
        phase_doctor_nvml()
        dist.destroy_process_group()
        phase_allreduce_entry(work_dir)
        # the two commands at once: neither has a rate bar, and each
        # checks only its own banner and reports
        ring, moe_started = start_ringattn_entry(work_dir), start_moe_entry(work_dir)
        try:
            phase_ringattn_entry(work_dir, ring)
        except BaseException:
            moe_started[0].stop()
            raise
        phase_moe_entry(work_dir, moe_started)
        phase_train_dp(work_dir)
        phase_ring_parity(work_dir)
        phase_ep_parity(work_dir)
        phase_pp_parity(work_dir)
        _, pair_launches = phase_tp_serve_parity(work_dir)
        tp_launches += pair_launches
        phase_llm_sp(work_dir)
        phase_hbm_pods_loop()
        queue = phase_queue_external(work_dir)
    phase_simulate((dwell_mfu_pct, loop_scale_up_s), (serve_saturated_pct, serve_scale_up_s))
    _host_only_finish(host_only, host_log)
    host_dir.cleanup()
    phase_processes()
    train = {n: parity_counts[n] + train_counts[n] + head256[n] for n in parity_counts}
    # the serve prefill's shape and the llm training shape, by dtype
    prefill = {row["dtype"]: row for row in flash_timing if row["bshd"] == [8, 512, 4, 128]}
    llm_rows = {row["dtype"]: row for row in bwd_timing if row["bshd"] == list(LLM_SHAPE)}
    path, llm = prefill["bf16"], llm_rows["bf16"]
    csrc = "k8s_gpu_hpa_tpu_torch/ops/csrc"
    row_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # f16's and f32's instantiations, each with its launches in the dtypes
    # phase's three paths and its own parity and timing rows
    new_kernels = []
    for dt in NEW_DTYPES:
        name = DT_NAME[dt]
        wgmma = dt == torch.float16
        gemm = timing["by_dtype"][name]
        new_kernels += [
            {"name": f"matmul_{name}", "route": "cuda",
             "source": f"{csrc}/{'matmul.cu' if wgmma else 'matmul_f32.cu'}",
             "replaces": "k8s_gpu_hpa_tpu/ops/pallas_matmul.py:56",
             "launches": dtypes[name]["matmul"], "max_abs_err": max_err[name],
             **{key: gemm[key] for key in row_keys}, "bound_peak": gemm["bound_peak"]},
            {"name": f"flash_attention_fwd_{name}", "route": "cuda",
             "source": f"{csrc}/{'flash_attention.cu' if wgmma else 'flash_attention_f32.cu'}",
             "replaces": "k8s_gpu_hpa_tpu/ops/flash_attention.py:59",
             "launches": dtypes[name]["fwd"], "max_abs_err": flash_err[name],
             **{key: prefill[name][key] for key in row_keys},
             "bound_peak": prefill[name]["bound_peak"],
             "shapes": [{key: row[key] for key in ("bshd", "with_lse", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms",
                                                   "library_backend")}
                        for row in flash_timing if row["dtype"] == name]},
            *({"name": f"flash_attention_bwd_{kernel}_{name}", "route": "cuda",
               "source": f"{csrc}/{'flash_attention_bwd.cu' if wgmma else 'flash_attention_bwd_f32.cu'}",
               "replaces": f"k8s_gpu_hpa_tpu/ops/flash_attention.py:{line}",
               "launches": dtypes[name][kernel], "max_abs_err": bwd_err[name][kernel],
               **{key: llm_rows[name][kernel][key] for key in row_keys},
               "bound_peak": llm_rows[name]["bound_peak"],
               "shapes": [{"bshd": row["bshd"], "library_backend": row["library_backend"],
                           **{key: row[kernel][key] for key in row_keys}}
                          for row in bwd_timing if row["dtype"] == name]}
              for kernel, line in (("dq", 165), ("dkv", 207))),
        ]
    # the chunked instantiations at head_dim 384 and 512, in bf16 and f16:
    # their launches in the head_wide phase, their numbers at the llm shape
    # at head_dim 512 (the wide phase's training path), every timed wide
    # shape beside them
    wide_kernels = []
    for dt in (torch.bfloat16, torch.float16):
        name = DT_NAME[dt]
        fwd_rows = [row for row in flash_timing
                    if row["dtype"] == name and row["bshd"][3] in WIDE_HEAD_DIMS]
        bwd_rows = [row for row in bwd_timing
                    if row["dtype"] == name and row["bshd"][3] in WIDE_HEAD_DIMS]
        fwd_head = next(row for row in fwd_rows if row["bshd"] == [1, 2048, 4, 512])
        bwd_head = next(row for row in bwd_rows if row["bshd"] == [1, 2048, 4, 512])
        wide_kernels += [
            {"name": f"flash_attention_fwd_d384_d512_{name}", "route": "cuda",
             "source": f"{csrc}/flash_attention.cu",
             "replaces": "k8s_gpu_hpa_tpu/ops/flash_attention.py:59",
             "launches": wide[name]["fwd"], "max_abs_err": flash_err[f"{name}_wide"],
             **{key: fwd_head[key] for key in row_keys}, "bound_peak": fwd_head["bound_peak"],
             "shapes": [{key: row[key] for key in ("bshd", "with_lse", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms",
                                                   "library_backend")} for row in fwd_rows]},
            *({"name": f"flash_attention_bwd_{kernel}_d384_d512_{name}", "route": "cuda",
               "source": f"{csrc}/flash_attention_bwd.cu",
               "replaces": f"k8s_gpu_hpa_tpu/ops/flash_attention.py:{line}",
               "launches": wide[name][kernel], "max_abs_err": bwd_err[f"{name}_wide"][kernel],
               **{key: bwd_head[kernel][key] for key in row_keys},
               "bound_peak": bwd_head["bound_peak"],
               "shapes": [{"bshd": row["bshd"], "library_backend": row["library_backend"],
                           **{key: row[kernel][key] for key in row_keys}} for row in bwd_rows]}
              for kernel, line in (("dq", 165), ("dkv", 207))),
        ]
    # the streamed instantiations, in each dtype (the f32 backward's on its
    # cluster tiling): their launches in the head1024 phase, their numbers
    # at the llm shape of that phase's width (bf16, f16: two heads of 1024;
    # f32: four of 512), every timed streamed shape beside them
    streamed_kernels = []
    for dt, name in DT_NAME.items():
        f32 = dt == torch.float32
        fwd_rows = [row for row in flash_timing
                    if row["dtype"] == name and flash_attention.streamed(row["bshd"][3], dt)]
        bwd_rows = [row for row in bwd_timing
                    if row["dtype"] == name and flash_attention.streamed(row["bshd"][3], dt)]
        shape = [1, 2048, 4, 512] if f32 else [1, 2048, 2, 1024]
        fwd_head = next(row for row in fwd_rows if row["bshd"] == shape)
        bwd_head = next(row for row in bwd_rows if row["bshd"] == shape)
        bwd_name, bwd_kind = ("cluster", "f32_cluster") if f32 else ("streamed", f"{name}_streamed")
        streamed_kernels += [
            {"name": f"flash_attention_fwd_streamed_{name}", "route": "cuda",
             "source": f"{csrc}/{'flash_attention_f32.cu' if f32 else 'flash_attention.cu'}",
             "replaces": "k8s_gpu_hpa_tpu/ops/flash_attention.py:59",
             "launches": streamed[name]["fwd"], "max_abs_err": flash_err[f"{name}_streamed"],
             **{key: fwd_head[key] for key in row_keys}, "bound_peak": fwd_head["bound_peak"],
             "shapes": [{key: row[key] for key in ("bshd", "with_lse", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms",
                                                   "library_backend")} for row in fwd_rows]},
            *({"name": f"flash_attention_bwd_{kernel}_{bwd_name}_{name}", "route": "cuda",
               "source": f"{csrc}/"
                         f"{'flash_attention_bwd_f32.cu' if f32 else 'flash_attention_bwd.cu'}",
               "replaces": f"k8s_gpu_hpa_tpu/ops/flash_attention.py:{line}",
               "launches": streamed[name][kernel],
               "max_abs_err": bwd_err[bwd_kind][kernel],
               **{key: bwd_head[kernel][key] for key in row_keys},
               "bound_peak": bwd_head["bound_peak"],
               "shapes": [{"bshd": row["bshd"], "library_backend": row["library_backend"],
                           **{key: row[kernel][key] for key in row_keys}} for row in bwd_rows]}
              for kernel, line in (("dq", 165), ("dkv", 207))),
        ]
    if any(row["launches"] <= 0 for row in streamed_kernels):
        raise AssertionError(f"a streamed kernel never launched on its path: {streamed}")
    emit({"kernels": [
        {
            "name": "matmul_bf16", "route": "cuda",
            "source": "k8s_gpu_hpa_tpu_torch/ops/csrc/matmul.cu",
            "replaces": "k8s_gpu_hpa_tpu/ops/pallas_matmul.py:56",
            "launches": launches, "max_abs_err": max_err["bf16"],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"],
        },
        {
            "name": "flash_attention_fwd_bf16", "route": "cuda",
            "source": "k8s_gpu_hpa_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "k8s_gpu_hpa_tpu/ops/flash_attention.py:59",
            # the serve loop's launches, the training paths' and head256's
            # burst, TP serving's and the serving container's
            "launches": flash_launches + train["fwd"] + tp_launches + queue["flash_launches"],
            "launches_head_dim_256": head256["fwd"],
            "max_abs_err": flash_err["bf16"],
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": path["library_ms"],
            # the same at each timed shape: the serve prefill (above), the
            # llm training shape with the logsumexp, the long one, and
            # head_dim 256's prefill and training shape
            "shapes": [
                {key: row[key] for key in ("bshd", "with_lse", "kv_split", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms",
                                           "library_backend")}
                for row in flash_timing if row["dtype"] == "bf16"
            ],
        },
        *(
            {
                "name": f"flash_attention_bwd_{name}_bf16", "route": "cuda",
                "source": "k8s_gpu_hpa_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                "replaces": f"k8s_gpu_hpa_tpu/ops/flash_attention.py:{line}",
                "launches": train[name], "launches_head_dim_256": head256[name],
                "max_abs_err": bwd_err["bf16"][name],
                "ms": llm[name]["ms"], "plain_ms": llm[name]["plain_ms"],
                "bound_ms": llm[name]["bound_ms"], "bound_by": llm[name]["bound_by"],
                # SDPA's backward computes dQ, dK and dV in one call: its
                # time times this kernel's share of the pair's operations
                "library_ms": llm[name]["library_ms"],
                # the same at each timed shape: the llm's (above), the long
                # one, and the llm's at head_dim 256
                "shapes": [
                    {"bshd": row["bshd"], "library_backend": row["library_backend"],
                     **{key: row[name][key] for key in ("ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")}}
                    for row in bwd_timing if row["dtype"] == "bf16"
                ],
                "library": "SDPA backward x {:.4f} of the pair's operations; whole call {} ms"
                           " against dQ + dK/dV {} ms".format(
                               llm[name]["library_share"], llm["pair"]["library_ms"],
                               llm["pair"]["ms"]),
            }
            for name, line in (("dq", 165), ("dkv", 207))
        ),
        *new_kernels,
        *wide_kernels,
        *streamed_kernels,
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
