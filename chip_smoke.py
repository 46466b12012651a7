#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--records N] [--points P] [--seed S]

Every phase must pass; any failure exits non-zero and nothing is caught
and passed over.

1. **Set-up.**  Prints the card's name and power limit as ``nvidia-smi``
   reports them, then builds every CUDA kernel from the sources in this
   checkout in one fresh build (one ``nvcc`` per source, all started
   together) and prints the build seconds and ``ptxas``'s register report
   of each.  The ``flash_attention`` library's SASS (``cuobjdump -sass``)
   must hold ``HGMMA`` (wgmma, Hopper's tensor-core product); the count is
   printed.
2. **Kernels.**  Holds each kernel against its plain PyTorch version on
   the card, and times both at the shape its path gives it (CUDA events
   around one call queued behind a device sleep, so the host's enqueue
   time is not counted; median of 20 after 3 warm-ups) beside the least
   time the card could take:
   - ``bucket_dest`` (and the ``bucket_dest`` / ``bucket_scatter`` entry
     points on it), exact, at the TeraSort stack ``[16, 655360]``, k=3,
     6 buckets;
   - ``bucket_partition``'s two entries, exact ids and histogram: the
     words entry at ``[10000000, 3]`` int64 words, 6 buckets; the rows
     entry, which reads the keys out of the records, over every key layout
     (range keys of 1-5 words with and without the length word, a key
     longer than the record, hash keys of 4, 8 and 10 bytes), widths 100,
     13 and 7, a storage offset that is not 4-aligned, N = 0, 1 and a
     ragged N, and timed at 10,000,000 records of 100 bytes (10-byte keys,
     k = 3, 6 buckets) beside the bound, the floors of the 32-byte sectors
     and 64-byte memory atoms its keys touch, and the route it replaced
     (the key rows built by plain torch, then the words entry);
   - ``kmeans_assign``, ids exact where the plain version's best-to-second
     gap exceeds ``1e-5 * (|x|^2 + |c|^2)`` and d2 within
     ``1e-5 * (|x|^2 + |c|^2) + 1e-6``, at ``[2097152, 8]``, K=10.  The
     plain version runs in full float32: TF32 is switched off for matrix
     products (``torch.backends.cuda.matmul.allow_tf32 = False``,
     ``torch.set_float32_matmul_precision("highest")``);
   - ``kmeans_partials``, the same source's fused entry (per-centroid sums
     and counts of one pass, every route: small and wide tables, vector
     and element loads, the shared-memory limit; float32 and bf16; masked
     and not): the same bits from two launches, counts exactly the masked
     ``bincount`` of ``kmeans_assign``'s ids and sums within
     ``1e-5 * sum |x| + 1e-6`` of float64 one-hot sums over them, and over
     the points whose id is decided, counts equal to the plain version's
     and sums within the same bound; at ``[2097152, 8]``, K=10, a full
     mask.
3. **TeraSort** through the port's ``SphereEngine`` on CUDA: ``--records``
   100-byte records (default 10,000,000, 1.0 GB) with random 10-byte keys
   and payload from ``--seed``, uploaded to Sector in record-aligned 64 MB
   chunks (640,000 records), replication 3, one chunk server per Teraflow
   site; 6 buckets from ``sample_boundaries``.  The outputs, concatenated
   in worker order, must be byte-identical to a numpy oracle (a stable
   lexsort of the keys, which must have no ties); ``bucket_dest`` must
   launch exactly once per shuffle round, with one host sync per round.
4. **partition_batch** on the TeraSort data on the card, through the range
   partitioner of the same boundaries: ids must equal a numpy oracle of
   ``#{bounds < key}``, the histogram the per-bucket record counts of the
   TeraSort outputs, and ``shuffle_batch``'s pieces, each sorted by key
   and concatenated, the oracle order; the rows entry of
   ``bucket_partition`` must launch exactly once per call and the words
   entry never.  One more ``partition_batch`` and the words route it
   replaced run under ``torch.profiler`` (device busy time and idle
   share), and ``shuffle_batch``'s host steps are timed one by one.
5. **k-means**, the paper's Table 2 workload (§5.3) at its largest scale:
   ``--points`` float32 points (default 100,000,000), D=8, K=10, 5
   iterations, a mixture of K Gaussian clusters from ``--seed``, uploaded
   to Sector in the default 64 MiB chunks (2,097,152 points each),
   replication 2, one chunk server per Teraflow site, and run by
   ``kmeans_sphere`` through one session.  The centroids must match a
   float64 Lloyd oracle in plain PyTorch on the card (same seeded init,
   same keep-empty rule, the lowest index on a tie) within ``rtol = atol
   = 1e-3``; ``udf_traces`` must be one per stage,
   ``kmeans_partials`` must launch once per assign task and iteration and
   the ids entry never.  One more iteration runs under
   ``torch.profiler``.

6. **LM kernels.**  ``recurrentgemma-2b`` at its full config (26 layers,
   ``d_model`` 2560, vocab 256,000, bf16) with parameters from ``--seed``
   on the card; one prefill of the 3,072-token prompt captures the q / k /
   v of its first local-attention layer and the a / b / h0 of its first
   RG-LRU layer.  Each kernel is held against its plain version on those
   activations and on a sweep of small cases, and timed as in phase 2
   beside its bound and, for attention, beside
   ``torch.nn.functional.scaled_dot_product_attention`` (timed only as a
   yardstick):
   - ``flash_attention`` (bf16: wgmma with TMA loads; float32: the SIMT
     kernel), local: q ``[1, 3072, 10, 256]``, k / v ``[1, 3072, 1,
     256]``, bf16, causal, window 2048; global (Qwen2.5-3B's shape): q
     ``[1, 3072, 16, 128]``, k / v ``[1, 3072, 2, 128]``, causal; within
     2e-5 in float32 and 2e-2 in bf16 (the bf16 kernel rounds p to bf16
     before the product with V, the plain version keeps it in float32),
     and in bf16 also within what rounding allows, plus 1e-4, of
     ``attention_tile_p``, which rounds p as the kernel does, relative to
     the running maximum after each 64-key tile (see ``tile_p_excess``;
     the excess against ``attention_rounded_p``, p rounded relative to
     the row's maximum, is printed beside it); TFLOP/s of the live pairs
     and the ratio to the
     library's time at both shapes;
   - ``rg_lru_scan`` (at prefill a ring in shared memory per warp of 32
     channels filled by TMA; at decode one thread a channel), exact,
     at prefill ``[1, 3072, 2560]`` and decode ``[4, 1, 2560]``, and at
     the ring's stage edges; TB/s and the ratio to the bound at both.
7. **Serving** through the port's ``ServeEngine`` (``max_batch=4``,
   ``max_len=4096``, greedy): 8 requests of 32 new tokens, prompts of
   3,072 and 2,500 tokens (longer than the window) and six lengths drawn
   from ``--seed`` in 16-512.  Every request must finish with 32
   in-vocabulary tokens and every slot be recycled; ``flash_attention``
   must launch exactly 8 times a prefill and ``rg_lru_scan`` 18 times a
   prefill and a decode step; the two long prompts' last prefill logits
   must match a reference prefill on the card in which both kernels are
   swapped for their plain versions (inside this script only) within
   ``5e-2`` of the reference logits' largest magnitude.  Prints time to
   first token, prefill and steady decode tokens/s, peak device memory,
   one decode step under ``torch.profiler`` (device busy time and idle
   share), and one prefill of the 3,072-token prompt under
   ``torch.profiler`` (device time by kernel: where the time to first
   token goes).
8. **Training** the full ``recurrentgemma-2b`` through the port's
   ``Trainer`` (fresh parameters from ``--seed``: the serving tensors
   were made for inference; fp32 AdamW state on the card), with full
   remat and the fused head (chunks of 512 tokens), at batch 2 x 3,072
   tokens (past the 2,048 window), on a synthetic corpus from ``--seed``
   of exactly one batch written to Sector, so the ``SectorTokenDataset``
   / ``DataPipeline`` feed that batch every step.  Checks: (a) one
   step's loss and every gradient leaf by the kernel route against the
   same step under ``plain_kernels()`` (loss within 1e-2; each leaf a
   relative error of at most 0.1 and a cosine of at least 0.99); (b) the
   scan's time-reversed backward through the kernel against autograd
   through the plain loop on the captured first RG-LRU layer ``[1, 3072,
   2560]``, within 1e-5 of the gradients' scale, both timed; (c) over 4
   steps at the JAX package's default learning rate and warm-up the loss
   falls and stays finite; (d) a Sector checkpoint round trip at
   ``cfg.reduced()`` on the card: saved at step 2, restored into a new
   ``Trainer`` bit for bit, its step-3 loss within 1e-3 of an
   uninterrupted run's; (e) the launches of the 4 steps exactly: under
   full remat 16 ``flash_attention`` a step (8 local layers, forward and
   recompute), 36 ``rg_lru_scan`` forward (18 R layers twice) and 18
   backward (``kernel.backward_launches``).  Prints each step's loss,
   grad norm, seconds (host clock, synchronised) and tokens/s, the peak
   device memory, the plain flash backward's time a step, one more step
   under ``torch.profiler`` (device busy, idle share, device time by
   class of kernel, by launching op and by kernel), and the AdamW
   update's device time (CUDA events, one more step).
9. **The mesh data plane** (``core/spmd.py``, ``SphereEngine(mesh=)``).
   (a) A one-rank NCCL group in this process (a ``file://`` store in a
   temporary directory; the communicator set up with the group) and
   phase 3's TeraSort again through ``SphereEngine(..., mesh=
   make_flat_mesh())``: the same cloud, records and boundaries.  The
   outputs must be byte-identical to the oracle, the report's simulated
   fields equal to phase 3's, one host sync per round, the shuffle the
   mesh round (``path="mesh"``), ``bucket_partition_rows`` launched once
   per round and ``bucket_dest`` never.  Prints the wall and records/s
   beside phase 3's, the rows kernel held exactly against its plain
   version on the round's input and timed, and one
   ``fused_scatter_round`` timed beside phase 3's single-device round
   (``scatter_round_dispatch`` and its harvest) on the same stage-0
   stack.  (b) 3 and then 4 ranks sharing the card over gloo (NCCL
   refuses two ranks on one GPU; gloo's collectives copy through the
   host), started by ``launch.mesh.run_ranks``; each rank builds its own
   cloud of 2,000,000 records (6 chunk servers, replication 3, 13 chunks
   of 16,000,000 bytes) from ``--seed`` and must pass: TeraSort
   byte-identical to a numpy oracle, through the mesh round at 3 ranks
   (the rows kernel once a round) and the gathered route at 4 (6 workers
   do not divide over 4 ranks; ``bucket_dest`` once a round); stage 0
   split over the ranks: the chunks a rank fetched (its tracer's
   ``fetch-chunk`` keys) exactly its own slots' chunks of the plan
   (``own_chunks``), the ranks' sets disjoint and covering the plan;
   ``distributed_sort`` and ``barrier_sort`` of 1,000,000 uint32 keys a
   rank equal to ``np.sort``; ``kmeans_step(mesh=)`` on 2,097,152 points
   within ``rtol = atol = 1e-5`` of the meshless step; ``kmeans_sphere``
   over a cloud of 12 x 2,097,152 points (D = 8, K = 10, 3 iterations,
   replication 2) on the mesh engine, its centroids and report equal bit
   for bit to the meshless run's in the same rank on the same cloud, the
   rank's ``kmeans_partials`` launches its own tasks x iterations and
   the ranks' sum chunks x iterations.  Prints a rank's chunks fetched,
   stage-0 seconds (fetch spans and ``exec:partition``), peak device
   memory after stage 0 and TeraSort wall, and the k-means launches and
   walls.  Any rank's failure fails the script.
10. **Serving ``xlstm-1.3b``** (arXiv:2405.04517, xLSTM[7:1]: 48 layers,
   ``d_model`` 2048, 4 heads, the pattern ``m`` x 7, ``s``; vocab 50,304;
   1,499,863,376 parameters at 48 layers) from ``--seed`` at full width and
   its first 8 layers (``XLSTM_SERVE_LAYERS``: one pattern unit; its
   sLSTM runs token by token, and the whole stack's 155-165 s, or two
   units' 51-72 s, left the run no room in its 1,200 s) through
   phase 7's harness, on a card freed of the earlier phases: (a) every
   request ends with 32 in-vocabulary tokens, every slot is recycled,
   and neither LM kernel launches (the path has none); (b) the first
   mLSTM layer's input, captured from the 3,072-token prefill, through
   the chunkwise form (chunks of 256) and the sequential oracle in
   float32 agree within 1e-3 of the output's largest magnitude; (c) the
   model's first pattern unit (8 layers) in float32 at full width on a
   512-token prompt: a prefill of 511 tokens (chunks of one token: 511
   is odd) and a decode of the 512th match the full forward's last two
   logit rows within 0.02 and 0.05 of their largest magnitude (the JAX
   package's ``tests/test_models.py`` bounds; at 48 layers the random
   weights make the float32 stack chaotic, in the JAX package too, see
   ``decode_consistency``).  Prints phase 7's serving lines, the peak device memory,
   the two long prefills' seconds (2,500 = 4 x 625: chunks of 4), one
   profiled decode step and one profiled 3,072-token prefill.
11. **Serving ``qwen3-moe-30b-a3b``** (hf:Qwen/Qwen3-30B-A3B: 48 layers,
   ``d_model`` 2048, GQA 32 / 4 heads of 128 with ``qk_norm``, rope
   theta 1e6, 128 experts of width 768, top-8; vocab 151,936;
   30,532,122,624 parameters, 61,089,411,072 bytes, from ``--seed``,
   nothing cut; the experts drawn a slice at a time) through the same
   harness: (a) as phase 10, with exactly 48 ``flash_attention`` launches
   a prefill and no ``rg_lru_scan``; (b) the two long prompts, layer by
   layer: each of the 48 layers' updates (attention plus MoE FFN) by the
   kernel route, recorded in a prefill whose logits must be the served
   ones, against the same layer under ``plain_kernels()`` from the same
   input with the routing pinned, within ``5e-2`` of the update's
   largest magnitude (end to end the two routes' logits are printed, not
   held: the random-weight 48-layer bf16 stack is chaotic, see
   ``check_moe_layers``); (c) the first MoE layer's input,
   captured from the 3,072-token prefill, through the ``einsum`` and the
   ``gather`` dispatch at the default capacity: the same tokens dropped
   whole and outputs within 2e-2 of the scale, both timed (CUDA events)
   beside the one-hot transport's FLOPs and the experts'; (d)
   ``flash_attention`` at this path's shape (the first attention layer's
   q ``[1, 3072, 32, 128]``, k / v ``[1, 3072, 4, 128]``, causal), held
   to its plain version as in phase 6 and timed beside SDPA and its
   bound (the kernels line's ``flash_attention`` row carries it under
   ``"qwen3-moe-30b-a3b"``).  Prints the serving lines and the peak
   device memory.
12. **Serving ``seamless-m4t-large-v2``** (arXiv:2308.11596: 24 encoder
   and 24 decoder layers, ``d_model`` 1024, 16 heads of 64, d_ff 8192,
   vocab 256,206; 2,035,935,232 parameters, 4,071,870,464 bytes, from
   ``--seed``, nothing cut) on a fresh card: (b) ``flash_attention`` at
   its three routes on the first
   layers' activations, captured from the 3,072-token prefill over 4,096
   frames (the encoder's non-causal self-attention ``[1, 4096, 16, 64]``,
   the decoder's causal one ``[1, 3072, 16, 64]``, the cross-attention
   of 3,072 queries over the 4,096 memory rows), each held as in phase 6
   and timed beside SDPA and its bound; (a) phase 7's requests, each with
   ``[1, 4096, 1024]`` frames from ``--seed``, with exactly 72
   ``flash_attention`` launches a request (24 encoder, 24 decoder self,
   24 cross); (c) every encoder and decoder layer of the long prompt's
   prefill from the kernel route's input against the plain route, as
   phase 11 (b) holds its layers; (d) the cross cache's plumbing in
   float32 at full width on one encoder and one decoder layer: a prefill
   of 511 tokens over 4,096 frames and one ``decode_step`` over the
   cached ``xk`` / ``xv`` match the forward's last two logit rows within
   1e-4 of their scale.  Prints the serving lines, one profiled decode
   step and one profiled prefill.
13. **Serving ``llava-next-mistral-7b``** (hf:llava-hf/llava-v1.6-mistral-
   7b-hf: 32 layers, ``d_model`` 4096, GQA 32 / 8 heads of 128, d_ff
   14,336, vocab 32,000, the vision projector; 7,275,286,528 parameters,
   14,550,573,056 bytes, from ``--seed``, nothing cut) on a fresh card:
   (b) one image prompt of 3,072 tokens with 2,880 anyres patch
   positions at 5..2884 and patch embeddings from ``--seed`` through
   ``model.prefill`` (32 ``flash_attention`` launches) and 31 greedy
   ``decode_step``s (none): ``splice_patches``
   equals a plain scatter of the projector's output exactly; prints its
   time to first token and decode tokens/s; (c) ``flash_attention`` at
   its first layer's captured shape (q ``[1, 3072, 32, 128]``, k / v
   ``[1, 3072, 8, 128]``, causal), held and timed as in 12 (b); (a)
   phase 7's text requests, 32 launches a prefill.  Prints the serving
   lines and the profiles.
14. **The LM training mesh: ``pjit``** on two gloo ranks sharing the card
   (``launch.mesh.run_ranks``; every collective staged through the
   host).  Phases 14-15 run right after phase 1, while this process holds
   nothing on the card.  First, in this process, one single-device forward and
   backward of phase 8's kind on the global batch of 2 x 3,072 tokens;
   each rank's slices of its gradient go to the temporary directory, and
   the same gradient as the token-weighted sum of the two rows' measures
   the single device's own bf16 spread, leaf by leaf.  Then
   ``recurrentgemma-2b`` at full width and its first pattern unit (13 of
   26 layers, ``MESH_LAYERS``, from ``--seed``) trains 2 steps through
   the port's ``Trainer`` on ``(data, model) = (2, 1)``, ``layout="tp"``,
   one row a rank, full remat, fused head: the step gathers the
   embedding and the final norm once and the pattern unit inside its
   remat wrapper (again in the recompute), and the gathers' backward
   reduce-scatters its gradient.  Each rank:
   step 1's loss within 2**-8 of itself of the single device's, the
   gradient norm within 1e-2 relative, each reduce-scattered gradient
   block within one bf16 rounding of the single device's token-weighted
   row sum, exactly one row's kernel launches (8, 18, 9 a step), the
   loss falling (the bytes a step handed to each collective are held to
   the dry run's count in phase 26); prints each rank's step seconds by
   part (the
   gathers and reduce-scatters inside the forward and backward apart),
   tokens/s, peak memory beside the whole-tree step's of PR 21 and the
   bytes a step by collective.  (14b) The 13-layer cut on the same mesh
   accumulating 2 microbatches (``accum_steps=2``) of a global batch of 4
   x 3,072, one row a rank in each, one step (``ACCUM_STEPS``): each
   rank's step-1 blocks
   within one bf16 rounding of a single-device reference that sums the
   rows' gradients token-weighted within each microbatch and averages
   the microbatches in float32, step 1's loss within 2**-8 of the
   single-device accumulated step's, twice one row's launches, the same
   prints.  The reduced config trained 2
   steps on the same mesh checkpoints at step 2 (rank 0 writes): a
   single-device ``Trainer`` restores it, leaf for leaf equal to the
   mesh's gathered tree.
15. **The LM training mesh: ``podwise``** on ``(pod, data, model) = (2,
   1, 1)``, the model cut to one pattern unit (13 of 26 layers: two
   replicas of 26 layers at 16 bytes a parameter would not fit), one row
   of 2,048 tokens a pod (each pod keeps the whole cut model: two at
   3,072 run out of the card): one forward and backward, then ``cross_pod_mean`` leaf by leaf
   on those gradients in float32 with ``none`` (equal to the all-reduce
   mean), ``bf16`` (within bf16 rounding of the leaf's largest |g|) and
   ``int8_ef`` (within amax / 64, a residual left), the bytes over
   ``pod`` 4 : 2 : 1 (plus int8's scale); then one full podwise
   ``int8_ef`` step of the ``Trainer`` (a finite loss; the pods' parameters
   equal, by exact checksums of their bits).  Prints the step's seconds
   and ``pod_efficiency_ratio`` against a one-rank step of the same cut
   model, a gloo-on-one-card figure.
16.-20. **Serving the four configs held last, and ``qwen2.5-3b``,** at
   full width in bf16 from ``--seed``, each on a fresh card after phase
   13: ``gemma3-12b`` (hf:google/gemma-3-12b-pt: 48 layers in units of 5
   local layers at window 1024 and one global, ``d_model`` 3840, GQA 16 /
   8 heads of 256, qk-norm, the local RoPE theta 1e4, GeGLU, tied and
   scaled embeddings, vocab 262,144; whole), ``qwen3-8b``
   (hf:Qwen/Qwen3-8B: 36 layers, GQA 32 / 8 heads of 128; whole),
   ``deepseek-7b`` (arXiv:2401.02954: 30 layers, MHA 32 / 32; whole),
   ``dbrx-132b`` (hf:databricks/dbrx-base: its first 8 of 40 layers,
   ``d_model`` 6144, GQA 48 / 8, 16 experts of width 10,752, top-4; the
   cut is printed) and ``qwen2.5-3b`` (hf:Qwen/Qwen2.5-3B: 36 layers, GQA
   16 / 2, QKV bias, tied embeddings; whole).  Each: ``flash_attention``
   at its first attention layer's captured shape (``gemma3-12b``: the
   first local and the first global layer), held and timed as in 11 (d),
   the ``kernels`` line's ``flash_attention`` row carrying it under the
   config's name and layer kind; the prefill's launches counted by layer
   kind (48: 40 local, 8 global / 36 / 30 / 8 / 36); (a) phase 7's
   requests, the launches exactly one a layer and prefill and no
   ``rg_lru_scan``; (b) every layer of both long prompts from the kernel
   route's input against ``plain_kernels()`` (12 (c)'s check, a unit of
   several layers split into its layers; ``dbrx-132b``'s with the
   routing pinned, as 11 (b)), the whole-stack plain logits printed; one
   profiled decode step and one profiled prefill.
21. **The MoE on the LM training mesh,** right after phases 14-15 on a
   card holding nothing of them: ``qwen3-moe-30b-a3b`` at full width
   (hf:Qwen/Qwen3-30B-A3B: ``d_model`` 2048, 128 experts of width 768,
   top-8, GQA 32 / 4 heads of 128) cut to 1 of its 48 layers
   (``MESH_MOE_LAYERS``), phase 14's knobs, a global batch of 2 x
   2,048 from ``--seed``.  (a) In this process: one forward and backward
   on the global batch by the kernel route held to ``plain_kernels()``
   (phase 8's bands at the mesh's rows); ``flash_attention`` at a row's
   shape (``[1, 2048, 32, 128]`` over 4 kv heads, causal, captured there)
   held and timed as in 11 (d); then each run's single-device reference,
   its ranks emulated by threads on the card (``emulated_rows``: each
   thread a rank's row, the MoE's collectives made of the threads'
   tensors in one autograd graph, one backward of the token-weighted
   sum).  (b) ``(data, model) = (2, 1)``, ``layout="tp"``, the ``einsum``
   dispatch: the global group of 4,096 tokens spans both ranks (the ids
   all-gathered, the aux statistics too).  (c) ``(1, 2)``,
   ``layout="fsdp"``, ``moe_dispatch="a2a"``: 64 experts a rank, each
   rank's 2,048 tokens routed as its own group at ``cap`` 160, the slot
   buffers exchanged by an all-to-all over ``model``; the step gathers
   a rank's 64 experts alone (over no axis on this mesh).  Each run spawns
   two fresh gloo ranks and trains 2 steps through the ``Trainer`` (full
   remat, fused head); each rank: step 1's loss and gradient norm and
   each gradient block held to its reference as in 14 (the blocks within
   one bf16 rounding of the emulated row sum; the distance from the
   whole-batch gradient printed), 4 ``flash_attention`` launches (forward
   and recompute of 1 layer, 2 steps), the loss falling; prints the step
   seconds by part with the gathers, the reduce-scatters and the MoE's
   exchange inside the forward and backward, the bytes a step by
   collective (``sharded.WIRE``; held to the dry run's in phase 26) and
   the peak memory.  The ``kernels`` line's ``flash_attention`` row carries
   the row's timing and ``mesh_moe_tp`` / ``mesh_moe_a2a`` launches.
14c. **Tensor-parallel training,** after phases 14-15: the 13-layer cut
   of ``recurrentgemma-2b`` (``POD_LAYERS``) on ``(data, model) = (1,
   2)``, ``layout="tp"``, one row of ``MESH_SEQ`` tokens, 2 steps (phase
   8's knobs): each rank computes the attention, FFN and RG-LRU layers on
   its half of the heads and widths.  The reference, in this process: the
   single-device step, and the same step with the two ``model`` ranks
   emulated on the card (``emulated_model_ranks``: each rank's layer
   called with its blocks, the partial outputs added in bf16 where the
   ranks' all-reduce adds them, the inputs' gradients summed as
   ``copy_to_model`` sums them).  Each rank: step 1's loss and gradient
   norm and each gradient block held to the emulation as in 14 (within
   one bf16 rounding; the plain step's distance printed), one row's
   launches, the step by part with the sums over ``model`` apart (the
   bytes a step, gathers, reduce-scatters and the sums over ``model``,
   held to the dry run's in phase 26).
22. **Serving on the mesh,** after phase 21: ``recurrentgemma-2b`` and
   ``qwen2.5-3b`` at full width, 13 and 9 layers (``MESH_SERVE_LAYERS``)
   served on two gloo ranks sharing the card
   at ``(data, model) = (1, 2)``, ``layout="tp"`` (``ServeEngine`` on
   each rank's blocks: ``recurrentgemma-2b``'s ring caches split over the
   sequence, ``qwen2.5-3b``'s over its kv heads), 4 requests of
   ``LONG_PROMPTS`` lengths, ``MAX_NEW`` greedy tokens each, over
   ``SERVE_SLOTS`` slots of ``SERVE_LEN``.  The single-device engine runs
   first in this process and is freed before the ranks start.  Each rank:
   (a) every layer of the first pattern unit teacher-forced from the
   single device's input, its update within ``TP_LAYER_TOL`` of the
   single device's; (b) each request's prefill last logits and the first
   decode step's logits (given the single device's tokens) within
   ``LOGIT_TOL`` of the single device with its two ranks emulated by
   threads (``threaded_serve``: the ranks' serve steps, their sums over
   ``model`` made of the threads' tensors), the plain single device's
   distance printed (``qwen2.5-3b``'s 36 random-weight bf16 layers are
   chaotic under the ranks' rounding); (c) exactly one ``flash_attention``
   launch a layer and prefill and one ``rg_lru_scan`` launch an R layer
   and prefill or decode call.  Then, in this process, ``flash_attention``
   at a rank's captured shapes (``[1, 3072, 5, 256]`` over 1 kv head with
   the window; ``[1, 3072, 8, 128]`` over 1) held and timed as in 11 (d)
   and ``rg_lru_scan`` at ``[1, 3072, 1280]`` and ``[4, 1, 1280]`` held
   exactly and timed.  Prints each rank's TTFT, decode tokens/s, peak
   memory and the bytes and seconds of its sums over ``model`` beside the
   serve's.  The ranks start once and serve each config in turn.
27. **The other families on the serving mesh,** after phase 22, as 22
   does (``MESH_FAMILY_CUTS``): ``qwen3-moe-30b-a3b`` at full width and 2
   of its 48 layers (64 of 128 experts a rank), ``seamless-m4t-large-v2``
   at 6 of its 24 encoder and 24 decoder layers (8 of 16 heads a rank,
   the encoder's, the decoder's and the cross blocks'; each request with
   ``SERVE_LEN`` frames, projected on a rank's half of the columns),
   ``xlstm-1.3b``'s first pattern unit (2 of 4 heads a rank) with
   ``MESH_SHORT_PROMPTS``.  Each rank: (a) every layer of
   each stack's first unit teacher-forced as in 22 (the MoE block from
   the single device's MoE input, so that both route alike; a cross
   layer's three split blocks within ``TP_CROSS_LAYER_TOL``); (b) and (c)
   as in 22: one ``flash_attention`` launch a layer and prefill for each
   route, none for the xLSTM.  Then ``flash_attention`` at a rank's
   captured shapes (seamless's encoder ``[1, 4096, 8, 64]`` non-causal and
   cross ``[1, 3072, 8, 64]`` over 4,096 frames, the MoE's ``[1, 3072,
   16, 128]`` over 2 kv heads) held and timed as in 11 (d).
28. **Five tensor-parallel ranks,** after phase 27: ``recurrentgemma-2b``
   at full width cut to ``("R", "R", "L")`` (``TP5_CUT``) on five gloo
   ranks sharing the card at ``(data, model) = (1, 5)``, spawned once:
   5 divides the LRU width, the 10 heads, ``d_ff`` and the vocabulary
   but not the 8 gate blocks, so each rank's 512 LRU columns cross the
   blocks of 320 and its gates come from the conv output all-gathered
   over ``model``.  2 steps of (14c)'s kind, held as (14c) to the single
   device with its 5 ranks emulated (the gathered RG-LRU route as
   ``gathered_lru``); then the 3,072-token prompt (``TP5_PROMPTS``) and
   ``MAX_NEW`` decode steps served from the same ranks, held as 22 to the
   single device's engine and its ranks emulated by threads.  Then
   ``rg_lru_scan`` at a rank's ``[1, 3072, 512]`` (prefill) and decode
   shapes and ``flash_attention`` at a rank's 2 heads of 256 over 1 kv
   head, held and timed; phase 26 holds the step's launches, arguments
   and bytes by collective.
23.-24. **Training ``seamless-m4t-large-v2`` and ``llava-next-mistral-7b``**
   at full width in bf16 from ``--seed``, each on a fresh card after
   phase 20, as the JAX package trains these families: ``step.
   make_train_step`` with an AdamW state from ``optim.init_state`` on one
   batch repeated (``family_batch``: 2 x 3,072 tokens and, shaped as
   ``models/inputs.py``'s ``train_batch_specs``, ``enc_frames`` ``[2,
   3072, 1024]`` or ``patch_embeds`` ``[2, 2880, 4096]`` with
   ``patch_pos`` at 5..2884), phase 8's knobs and learning rate, 8 steps
   (``FAMILY_STEPS``: seamless's loss wanders over the first 4, in
   float32 too);
   ``llava-next-mistral-7b`` at its first 12 of 32 layers (46.6 GB of
   state; the cut is printed).  First ``flash_attention`` at each
   training shape (the first launch of each route in one bf16 forward)
   held and timed as in 11 (d), and its plain backward timed at those
   shapes, times its calls a step.  (a) One step's loss and every
   gradient by the kernel route, within phase 8's bands: at full depth in
   float32 (``FAMILY_CHECK_DTYPE``; the SIMT kernel) against
   ``plain_kernels()``, and in bf16 (the wgmma kernel the steps launch)
   at one pattern unit against ``tile_p_attention()``, a plain version
   rounding p as that kernel does (deeper, the random-weight bf16 stack
   parts any two roundings' gradients, ``scripts/depth_divergence.py
   --card``): seamless's encoder (non-causal), decoder (causal) and
   cross-attention at D = 64 under autograd; then the bf16 steps: (b) the loss falls,
   finite; (c) exactly twice a forward's ``flash_attention`` launches a
   step (144: 24 encoder, 24 decoder and 24 cross launches; 24); (d) the
   peak device memory below the card's.
25. **Training ``xlstm-1.3b``** at full width and its first pattern unit
   (8 of 48 layers, ``XLSTM_TRAIN_LAYERS``: a step of the whole stack
   took 80-114 s) through the ``Trainer`` on a fresh card (tokens only,
   as phase 8), 2 x 3,072, full remat, 2 steps (``XLSTM_TRAIN_STEPS``).
   The family runs no
   kernel, so (a) holds one step's loss and every gradient on the card
   against the same code on the CPU: the first pattern unit (7 mLSTM and
   1 sLSTM layers) with the embedding and head, float32 without TF32,
   one row of 8 tokens (``XLSTM_CHECK_SEQ``: longer rows amplify the
   float32 sums' order past the bar), each leaf within 1e-3 relative L2
   (what the CPU's own gradient moves when its embeddings move by one ulp
   is printed beside), the sLSTM's ``b_i``, whose gradient is zero in
   exact arithmetic, below 1e-5 of ``b_f``'s in norm; (b) the loss
   falls, finite, no kernel launches.  Prints the steps' seconds,
   tokens/s and peak memory.

26. **The dry run held to the card's steps** (``launch/dryrun.py``, which
   counts one rank's step on meta tensors, a stand-in default group of
   the mesh's size behind it; no card).  Its counts of the steps above
   run on the host beside phases 2-25, started after the host-staged
   mesh phases 14-22 (``start_dryrun``, a process of its own with the
   card hidden from it): phase 8's step, phase 14's rank
   on a ``(2, 1)`` stand-in mesh, (14b), (14c) and phase 21's two runs,
   phases 23-24's steps and phase 17's warm ``qwen3-8b`` prefill of 3,072
   tokens (cache of ``SERVE_LEN``), with the phases' knobs, rows and
   tokens.  Each is held to the card's step (``MEASURED``): every
   kernel's launches a step and the bytes of the arguments it held
   exactly; each mesh rank's bytes a step by collective
   (``sharded.WIRE``) exactly; the peak (``max_memory_allocated`` less
   what the process held beside the arguments; a mesh step's without
   step 1's gradient check, whose peak is printed) within 15%; the dry
   run's FLOPs over the step's median seconds at 989 TFLOP/s printed
   beside the card's name and power limit.  The dry run's command line on
   ``recurrentgemma-2b train_4k 16x16`` and ``qwen3-8b decode_32k
   2x16x16`` must write ``ok`` records.

The line before the last is one JSON object describing every kernel; the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the rest of the repository beside this
script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RECORD, KEY = 100, 10
CHUNK_RECORDS = 640_000                 # 64,000,000-byte chunks
N_BUCKETS = 6
MAIN_SLOTS, MAIN_ROWS = 16, 655_360     # the stage-0 stack at 10M records
PART_ROWS = 10_000_000                  # partition_batch over 10M records
DIM, K, ITERS = 8, 10, 5                # benchmarks/table2_kmeans.py
ASSIGN_ROWS = 2_097_152                 # points in one 64 MiB chunk
# H100 SXM data-sheet peaks (NVIDIA): HBM bandwidth, and the 32-bit
# non-tensor rate used as the ceiling for integer compares and float32
# FMAs
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_PER_S = 989e12                # dense bf16 tensor-core rate
SLEEP_CYCLES = 2_000_000                # ~1 ms of device sleep before a timed call
PKG = "src/repro_torch/kernels"
KERNELS = {
    "bucket_dest": (f"{PKG}/bucket_partition/csrc/bucket_dest.cu",
                    "src/repro/kernels/bucket_partition/kernel.py:138"),
    "bucket_partition": (f"{PKG}/bucket_partition/csrc/bucket_partition.cu",
                         "src/repro/kernels/bucket_partition/kernel.py:70"),
    # the same source's rows entry: the TPU kernel and the key extraction
    # XLA fuses in front of it (src/repro/core/shuffle.py _extract_keys)
    "bucket_partition_rows": (
        f"{PKG}/bucket_partition/csrc/bucket_partition.cu",
        "src/repro/kernels/bucket_partition/kernel.py:70"),
    "kmeans_assign": (f"{PKG}/kmeans_assign/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kernel.py:19"),
    # the same source's fused entry: the TPU kernel and the one-hot
    # partials around it (src/repro/kernels/kmeans_assign/ops.py)
    "kmeans_partials": (f"{PKG}/kmeans_assign/csrc/kmeans_assign.cu",
                        "src/repro/kernels/kmeans_assign/kernel.py:19"),
    "flash_attention": (f"{PKG}/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:29"),
    "rg_lru_scan": (f"{PKG}/rg_lru_scan/csrc/rg_lru_scan.cu",
                    "src/repro/kernels/rg_lru_scan/kernel.py:23"),
    # the same kernel on the gradient's time-reversed recurrence (the
    # JAX package differentiates an associative scan; the Pallas kernel
    # has no gradient)
    "rg_lru_scan_backward": (f"{PKG}/rg_lru_scan/csrc/rg_lru_scan.cu",
                             "src/repro/kernels/rg_lru_scan/kernel.py:23"),
}
LM_ARCH = "recurrentgemma-2b"
LONG_PROMPTS = (3072, 2500)             # longer than the 2,048 window
N_REQUESTS, MAX_NEW, SERVE_SLOTS, SERVE_LEN = 8, 32, 4, 4096
LOGIT_TOL = 5e-2                        # of the reference's largest |logit|
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 3072, 4
HEAD_CHUNK = 512
# (a): the kernel route against plain_kernels() on one batch.  Only the
# attention forward differs (the bf16 kernel rounds p to bf16, the plain
# version keeps it in float32), in 8 of 26 layers: the loss within 1e-2
# (the bf16 logits round by 2**-9 of themselves; a loss near 12.5 moves
# by up to about 0.02 at worst), and each gradient leaf within a relative
# (Frobenius) error of 0.1 and a cosine of at least 0.99
TRAIN_LOSS_TOL, GRAD_REL_TOL, GRAD_COS_MIN = 1e-2, 0.1, 0.99
# (b): the scan's backward against autograd through the plain loop, of
# the gradients' largest magnitude (the same multiplies and adds; autograd
# adds a step's two contributions in its own order)
SCAN_GRAD_TOL = 1e-5
RESUME_LOSS_TOL = 1e-3                  # (d): the resumed step-3 loss


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync(torch, device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, warmup: int = 3, runs: int = 20) -> float:
    """Median device time of ``fn()`` in milliseconds: CUDA events around
    one call, queued behind a device sleep so that the host's time to
    enqueue the call is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int, ops_per_s: float = PEAK_OPS_PER_S):
    """(least time in ms, what bounds it) for moving ``n_bytes`` through
    device memory and doing ``n_ops`` operations at ``ops_per_s`` (default
    the 32-bit rate)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(name, worst, ms, plain, bound, by, library=None):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": library}


# phase 26: each reused step's launches a step, the bytes of the arguments
# it held, its peak less what else the process held, its median seconds
# (and a mesh rank's bytes a step by collective), by the dry run's key
MEASURED = {}


def tree_nbytes(tree) -> int:
    """Bytes of a nested dict's tensors."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.nbytes


def noting_batch(step):
    """``step(params, opt, batch)`` that notes its batch's bytes in the
    dict returned beside it."""
    seen = {"batch": 0}

    def noted(params, opt, batch):
        seen["batch"] = tree_nbytes(batch)
        return step(params, opt, batch)
    return noted, seen


def step_held(launches, steps: int, held: int, peak: int, secs,
              wire=None) -> dict:
    """What phase 26 holds a reused step's dry run to: ``launches`` (a
    run's flash, scan and scan backward) a step, the arguments' bytes,
    the step's peak (max_memory_allocated less what the process held
    beside the arguments), the median step seconds after the first."""
    secs = list(secs)
    return {"launches": tuple(n // steps for n in launches),
            "argument_bytes": int(held), "peak": int(peak),
            "step_s": statistics.median(secs[1:] or secs), "wire": wire}


def ranks_held(res, key: str) -> dict:
    """Rank 0's :func:`step_held` of a mesh step ``key``, with every
    rank's bytes a step by collective: the ranks are symmetric, so phase
    26 holds each rank's to the dry run's count of rank 0."""
    return {**res[0][key]["held"],
            "wire": [out[key]["held"]["wire"] for out in res]}


def spans_line(tracer) -> str:
    """Wall seconds per span name.  Device work is asynchronous, so it
    lands in the span that waits for it."""
    totals: dict = {}
    for sp in tracer.snapshot():
        if sp.kind == "span" and sp.clock == "wall":
            totals[sp.name] = totals.get(sp.name, 0.0) + sp.wall_seconds
    return " ".join(f"{name}={sec:.4f}" for name, sec in sorted(totals.items()))


def cloud(tmp: Path, chunk_size=None):
    """A Sector master with one chunk server per Teraflow site."""
    from repro_torch.sector import ChunkServer, SectorClient, SectorMaster
    master = (SectorMaster() if chunk_size is None
              else SectorMaster(chunk_size=chunk_size))
    for i, site in enumerate(master.topology.sites):
        master.register(ChunkServer(f"s{i}", site, tmp))
    master.acl.add_member("u")
    master.acl.grant_write("u")
    return master, SectorClient(master, "u", "chicago")


# ------------------------------------------------------------ phase 1
def build_all(build_dir: Path) -> None:
    """One fresh build of every kernel source, one nvcc each, in parallel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_partition import kernel as bkernel
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.kmeans_assign import kernel as kkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    shutil.rmtree(build_dir, ignore_errors=True)

    def one(src):
        t = time.perf_counter()
        lib = _build.build(ROOT / src, build_dir)
        return lib, time.perf_counter() - t

    sources = sorted({src for src, _ in KERNELS.values()})
    t = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(one, sources)))
    print(f"build: {len(built)} sources ({len(KERNELS)} kernels) in "
          f"{time.perf_counter() - t:.2f}s")
    for src, (lib, sec) in built.items():
        print(f"build: {src}: {lib.relative_to(ROOT)} in {sec:.2f}s")
        print((lib.parent / f"{Path(src).stem}.log").read_text().strip())
    n_hgmma = fkernel.hgmma_count(build_dir)
    print(f"build: flash_attention SASS holds {n_hgmma} HGMMA instructions")
    check(n_hgmma > 0, "the flash_attention library has no HGMMA (wgmma) "
                       "instruction")
    bkernel.load_library(build_dir)
    bkernel.load_partition_library(build_dir)
    kkernel.load_library(build_dir)
    fkernel.load_library(build_dir)
    lkernel.load_library(build_dir)


# ------------------------------------------------------------ phase 2
def dest_phase(torch):
    from repro_torch.convert import bounds_from_numpy
    from repro_torch.core import shuffle
    from repro_torch.core.records import extract_keys
    from repro_torch.kernels.bucket_partition import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    worst = 0

    def compare(keys, bounds, counts, mask, n_out, bn, data=None):
        nonlocal worst
        valid = (mask != 0 if mask is not None else
                 torch.arange(keys.shape[1], device=dev) < counts[:, None])
        got = kernel.bucket_dest_blocks(keys, bounds, counts, mask,
                                        n_out=n_out, bn=bn)
        want = ref.bucket_blocks_ref(keys, bounds, valid, n_out, bn)
        for name, g, w in zip(("ids", "rank", "bhist"), got, want):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            worst = max(worst, err)
            check(err == 0, f"bucket_dest {name} differs from the plain "
                            f"version (n_out={n_out}, bn={bn}, max err {err})")
        nv = mask if mask is not None else counts
        dest, hist = ops.bucket_dest(keys, bounds, nv, n_buckets=n_out,
                                     block_n=bn)
        r_dest, r_hist = ref.bucket_dest_ref(keys, bounds, valid, n_out, bn)
        check(torch.equal(dest, r_dest) and torch.equal(hist, r_hist),
              f"bucket_dest differs from the plain version (n_out={n_out})")
        if data is not None:
            out, _ = ops.bucket_scatter(data, keys, bounds, nv,
                                        n_buckets=n_out, block_n=bn)
            want_out = torch.empty_like(data)
            s = data.shape[0]
            want_out[torch.arange(s, device=dev)[:, None], r_dest] = data
            check(torch.equal(out, want_out),
                  f"bucket_scatter bytes differ (n_out={n_out})")

    def rand_case(s, n, k, n_bounds, high):
        keys = torch.randint(0, high, (s, n, k), generator=gen,
                             dtype=torch.int64)
        rows = torch.randint(0, high, (n_bounds, k), generator=gen,
                             dtype=torch.int64)
        counts = torch.randint(0, n + 1, (s,), generator=gen,
                               dtype=torch.int32)
        mask = (torch.rand((s, n), generator=gen) < 0.7).to(torch.int32)
        data = torch.randint(0, 256, (s, n, 8), generator=gen,
                             dtype=torch.uint8)
        return [t.to(dev) for t in (keys, rows, counts, mask, data)]

    n_cases = 0
    # low-entropy words: boundary-equal keys, multi-word ties, duplicates
    for k in (1, 3, 4):
        for n_out in (2, 6, 16, 64):
            for bn in (7, 32, 101, 2048):
                keys, bounds, counts, mask, data = rand_case(3, 1000, k,
                                                             n_out - 1, 4)
                compare(keys, bounds, counts, None, n_out, bn, data)
                compare(keys, bounds, None, mask, n_out, bn, data)
                n_cases += 2
    # the n_out clamp: more boundaries than buckets
    keys, bounds, counts, mask, data = rand_case(2, 900, 3, 9, 4)
    for n_out in (1, 3):
        compare(keys, bounds, counts, None, n_out, 32, data)
        n_cases += 1
    # a wide bucket table
    keys, bounds, counts, mask, data = rand_case(2, 3000, 3, 999, 3)
    compare(keys, bounds, counts, None, 1000, 257, data)
    n_cases += 1
    # variable-length boundaries and zero-tail ties through the shuffle's
    # own key extraction (the trailing length word), against bytes order
    bnd = [b"\x10\x20", b"\x10\x20\x00", b"\x10\x20\x00\x00\x00\x01",
           b"\x40" * 10, b"\x80" * 9 + b"\x00"]
    part = shuffle.range_partitioner(bnd)
    prefixes = [b"\x00\x00", b"\x10\x1f", b"\x10\x20", b"\x10\x21",
                b"\x10\x20\x00\x00\x00\x00", b"\x10\x20\x00\x00\x00\x01",
                b"\x40" * 10, b"\x40" * 9 + b"\x41", b"\x80" * 9 + b"\x00",
                b"\x80" * 9 + b"\x01", b"\xff" * 10]
    records = [(p + bytes(12))[:12] for p in prefixes for _ in range(37)]
    batch = shuffle.RecordBatch.from_records(records, device=dev)
    pieces = shuffle.scatter_batch(batch, part, 6, pad_block=64)
    want = [[r for r in records if part(r, 6) == b] for b in range(6)]
    check([p.to_bytes() for p in pieces] == [b"".join(w) for w in want],
          "variable-length boundary scatter differs from bytes order")
    n_cases += 1

    # 64 buckets on random record keys
    dgen = torch.Generator(device=dev).manual_seed(4321)
    data = torch.randint(0, 256, (MAIN_SLOTS, 65_536, RECORD), generator=dgen,
                         dtype=torch.uint8, device=dev)
    spec, bwords = shuffle.range_partitioner(sorted(
        bytes(r) for r in np.random.default_rng(5).integers(
            0, 256, (63, KEY), dtype=np.uint8))).scatter_spec(
        shuffle.RecordBatch.empty(RECORD, dev), 64)
    keys = extract_keys(data, spec).contiguous()
    bounds = bounds_from_numpy(bwords).to(dev)
    counts = torch.full((MAIN_SLOTS,), 60_000, dtype=torch.int32, device=dev)
    compare(keys, bounds, counts, None, 64, ops.ACCEL_BLOCK_N, data)
    n_cases += 1

    # the main path's shape: 16 slots x 655,360 rows, k=3, 6 buckets
    data = torch.randint(0, 256, (MAIN_SLOTS, MAIN_ROWS, RECORD),
                         generator=dgen, dtype=torch.uint8, device=dev)
    sample = [bytes(r) for r in data[0, :5000, :KEY].cpu().numpy()]
    part = shuffle.range_partitioner(
        shuffle.sample_boundaries(sample, N_BUCKETS, KEY))
    spec, bwords = part.scatter_spec(shuffle.RecordBatch.empty(RECORD, dev),
                                     N_BUCKETS)
    keys = extract_keys(data, spec).contiguous()
    bounds = bounds_from_numpy(bwords).to(dev)
    counts = torch.tensor([640_000] * 15 + [400_000], dtype=torch.int32,
                          device=dev)
    bn = ops.ACCEL_BLOCK_N
    compare(keys, bounds, counts, None, N_BUCKETS, bn, data)
    n_cases += 1
    torch.cuda.synchronize()

    valid = torch.arange(MAIN_ROWS, device=dev) < counts[:, None]
    ids, rank, bhist = kernel.bucket_dest_blocks(keys, bounds, counts, None,
                                                 n_out=N_BUCKETS, bn=bn)
    kernel_ms = timed_ms(torch, lambda: kernel.bucket_dest_blocks(
        keys, bounds, counts, None, n_out=N_BUCKETS, bn=bn))
    plain_ms = timed_ms(torch, lambda: ref.bucket_blocks_ref(
        keys, bounds, valid, N_BUCKETS, bn))
    # the bytes the function needs: k 32-bit words of key for each real
    # row (rows that are not real go to the trash bucket unread), ids and
    # rank out for every row, the block histograms, the row counts and the
    # boundary words.  The int64 carriage of the words is the port's
    # choice: the kernel as built reads twice the key bytes (`carried`).
    rows = MAIN_SLOTS * MAIN_ROWS
    real = int(counts.sum())
    n_bounds, k = bounds.shape
    fixed = rows * 8 + 4 * (bhist.numel() + counts.numel() + n_bounds * k)
    k_bytes = real * 4 * k + fixed
    key_bytes = real * KEY + fixed          # the 10 key bytes alone
    carried = real * 8 * k + fixed
    k_ops = real * n_bounds * k * 2
    k_bound, k_by = bound_ms(k_bytes, k_ops)
    key_bound, _ = bound_ms(key_bytes, k_ops)
    scatter_ms = timed_ms(torch, lambda: ops.bucket_scatter(
        data, keys, bounds, counts, n_buckets=N_BUCKETS))
    out, hist = ops.bucket_scatter(data, keys, bounds, counts,
                                   n_buckets=N_BUCKETS)
    # every row in and out (the output is a permutation of all rows, the
    # trash included), the histogram, the counts and the boundary words;
    # the key words are made from the rows, so they are not counted
    s_bytes = (data.nbytes + out.nbytes + hist.nbytes + counts.nbytes
               + 4 * n_bounds * k)
    s_bound, _ = bound_ms(s_bytes, k_ops)
    print(f"kernel bucket_dest [{MAIN_SLOTS}, {MAIN_ROWS}] k={k} "
          f"n_out={N_BUCKETS} real_rows={real}: kernel_ms={kernel_ms:.4f} "
          f"bound_ms={k_bound:.4f} ({k_bytes} bytes, 32-bit key words) "
          f"key_bytes_bound_ms={key_bound:.4f} ({key_bytes} bytes) "
          f"carried_bytes={carried} "
          f"({carried / (kernel_ms * 1e-3) / 1e12:.3f} TB/s) "
          f"plain_ms={plain_ms:.4f} cases={n_cases} max_abs_err={worst}")
    print(f"bucket_scatter (kernel + epilogue + row move) "
          f"[{MAIN_SLOTS}, {MAIN_ROWS}, {RECORD}]: scatter_ms="
          f"{scatter_ms:.4f} bound_ms={s_bound:.4f} ({s_bytes} bytes)")
    return row("bucket_dest", worst, kernel_ms, plain_ms, k_bound, k_by)


def key_floor_bytes(ptr: int, n: int, width: int, kb: int, grain: int
                    ) -> int:
    """Bytes of the ``grain``-byte blocks of device memory that the first
    ``kb`` bytes of ``n`` records of ``width`` bytes from address ``ptr``
    touch: what the memory must move to read the keys alone."""
    first = ptr % grain + np.arange(n, dtype=np.int64) * width
    return int(((first + kb - 1) // grain - first // grain + 1).sum()) * grain


def rows_cases(torch, dev, gen):
    """``(data, key_spec, bounds, n_buckets)`` cases of the rows entry:
    range keys of k = 1..5 words with and without the length word, a key
    longer than the record (clipped), hash keys of 4, 8 and 10 bytes;
    widths 100, 13 and 7; a view whose storage offset is not 4-aligned;
    N = 0, 1 and a ragged N.  Low-entropy bytes and boundaries taken from
    the records' own keys give boundary ties and multi-word ties."""
    from repro_torch.core.records import extract_keys, uniform_hash_bounds
    from repro_torch.kernels.bucket_partition.kernel import key_layout

    def sampled_bounds(data, spec, nb):
        keys = extract_keys(data, spec)
        if not len(keys):
            return torch.zeros((nb - 1, key_layout(spec, data.shape[1])[3]),
                               dtype=torch.int64)
        pick = keys[torch.randint(0, len(keys), (nb - 1,), generator=gen)]
        return pick[torch.from_numpy(np.lexsort(pick.numpy().T[::-1]))]

    specs = [("range", 4, 1, None), ("range", 4, 1, 4),
             ("range", 8, 2, None), ("range", 10, 3, None),
             ("range", 10, 3, 10), ("range", 6, 3, None),
             ("range", 16, 4, 16), ("range", 20, 5, None),
             ("range", 12, 3, 12),         # longer than a 7-byte record
             ("hash", 4), ("hash", 8), ("hash", 10)]
    for width in (100, 13, 7):
        for offset in ((0, 1) if width == 100 else (0,)):
            for n in (3001, 1, 0):
                flat = torch.randint(0, 2, (n * width + offset,),
                                     generator=gen, dtype=torch.uint8)
                host = flat[offset:].view(n, width)
                data = flat.to(dev)[offset:].view(n, width)
                for spec in specs:
                    for nb in (2, 6, 16):
                        if spec[0] == "hash":
                            bounds = torch.from_numpy(uniform_hash_bounds(
                                nb).astype(np.int64))[:, None]
                        else:
                            bounds = sampled_bounds(host, spec, nb)
                        yield data, spec, bounds.to(dev), nb


def partition_phase(torch):
    """Both entries of bucket_partition.cu against their plain versions;
    returns their two rows."""
    from repro_torch.convert import bounds_from_numpy
    from repro_torch.core import shuffle
    from repro_torch.core.records import extract_keys
    from repro_torch.kernels.bucket_partition import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    worst = worst_rows = 0
    n_cases = n_rows = 0

    def differ(name, got, want, what):
        err = 0
        for g, w in zip(got, want):
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        check(err == 0, f"{name} {what} differs from the plain version (max "
                        f"err {err})")
        return err

    def compare(keys, bounds, n_buckets, bn, entry=True):
        nonlocal worst, n_cases
        got = kernel.bucket_partition_ids(keys, bounds, n_buckets=n_buckets,
                                          bn=bn)
        want = ref.bucket_partition_ref(keys, bounds, n_buckets)
        worst = max(worst, differ(
            "bucket_partition", got, want, f"(n={keys.shape[0]}, k="
            f"{keys.shape[1]}, nb={n_buckets}, bn={bn})"))
        if entry:
            ids, hist = ops.bucket_partition(keys, bounds,
                                             n_buckets=n_buckets, block_n=bn)
            check(torch.equal(ids, want[0]) and torch.equal(hist, want[1]),
                  f"ops.bucket_partition differs (nb={n_buckets})")
        n_cases += 1

    def compare_rows(data, spec, bounds, n_buckets, bn=None):
        nonlocal worst_rows, n_rows
        got = kernel.bucket_partition_rows(data, spec, bounds,
                                           n_buckets=n_buckets, bn=bn)
        want = ref.bucket_partition_rows_ref(data, spec, bounds, n_buckets)
        worst_rows = max(worst_rows, differ(
            "bucket_partition_rows", got, want, f"(shape "
            f"{tuple(data.shape)}, offset {data.storage_offset()}, "
            f"spec {spec}, nb={n_buckets}, bn={bn})"))
        ids, hist = ops.bucket_partition_rows(data, spec, bounds,
                                              n_buckets=n_buckets,
                                              block_n=bn)
        check(torch.equal(ids, want[0]) and torch.equal(hist, want[1]),
              f"ops.bucket_partition_rows differs ({spec}, nb={n_buckets})")
        n_rows += 1

    def rand(shape, high):
        return torch.randint(0, high, shape, generator=gen,
                             dtype=torch.int64).to(dev)

    # low-entropy words: boundary ties, multi-word ties, duplicates;
    # a ragged N (not a multiple of any block)
    for k in (1, 3, 4):
        for nb in (2, 6, 16, 64):
            for bn in (7, 256, 2048):
                keys, bounds = rand((3001, k), 4), rand((nb - 1, k), 4)
                bounds = bounds[torch.from_numpy(np.lexsort(
                    bounds.cpu().numpy().T[::-1])).to(dev)]
                compare(keys, bounds, nb, bn)
    # N = 0 and one row
    compare(rand((0, 3), 4), rand((5, 3), 4), 6, 2048)
    compare(rand((1, 3), 4), rand((5, 3), 4), 6, 2048)
    # overflow ids: more boundary rows than buckets, at the kernel's own
    # level (unclamped ids, counted in no bin)
    keys, bounds = rand((5000, 3), 4), rand((9, 3), 4)
    for nb in (2, 4):
        compare(keys, bounds, nb, 128, entry=False)
    # full-range 32-bit words
    compare(rand((70_001, 3), 2 ** 32), rand((5, 3), 2 ** 32), 6, 2048)
    # the rows entry: every key layout, width, alignment and size above
    for data, spec, bounds, nb in rows_cases(torch, dev, gen):
        compare_rows(data, spec, bounds, nb)
    torch.cuda.synchronize()

    # the path's shape: 10,000,000 records of 100 bytes, their 10-byte
    # keys as k = 3 words, 6 buckets
    dgen = torch.Generator(device=dev).manual_seed(77)
    data = torch.randint(0, 256, (PART_ROWS, RECORD), generator=dgen,
                         dtype=torch.uint8, device=dev)
    sample = sorted(bytes(r) for r in data[:100_000, :KEY].cpu().numpy())
    part = shuffle.range_partitioner(
        shuffle.sample_boundaries(sample, N_BUCKETS, KEY))
    spec, bwords = part.scatter_spec(shuffle.RecordBatch(data), N_BUCKETS)
    bounds = bounds_from_numpy(bwords).to(dev)
    keys = extract_keys(data, spec).contiguous()
    bn = ops.ACCEL_BLOCK_N
    compare(keys, bounds, N_BUCKETS, bn)
    compare_rows(data, spec, bounds, N_BUCKETS)
    # a storage offset that is not 4-aligned takes the byte loads
    compare_rows(data.view(-1)[1:1 + (PART_ROWS - 1) * RECORD].view(
        PART_ROWS - 1, RECORD), spec, bounds, N_BUCKETS)
    words_ms = timed_ms(torch, lambda: kernel.bucket_partition_ids(
        keys, bounds, n_buckets=N_BUCKETS, bn=bn))
    words_plain_ms = timed_ms(torch, lambda: ref.bucket_partition_ref(
        keys, bounds, N_BUCKETS))
    rows_ms = timed_ms(torch, lambda: kernel.bucket_partition_rows(
        data, spec, bounds, n_buckets=N_BUCKETS))
    rows_plain_ms = timed_ms(torch, lambda: ref.bucket_partition_rows_ref(
        data, spec, bounds, N_BUCKETS))
    # the route the partition path took before the rows entry: the key
    # rows built by plain torch, then the words entry
    old_ms = timed_ms(torch, lambda: ops.bucket_partition(
        extract_keys(data, spec), bounds, n_buckets=N_BUCKETS))
    n_bounds, k = bounds.shape
    small = 4 * (N_BUCKETS + n_bounds * k)
    p_ops = PART_ROWS * n_bounds * k * 2
    # words: 32-bit key words in, ids out, the histogram and the bounds
    p_bytes = PART_ROWS * (4 * k + 4) + small
    p_bound, p_by = bound_ms(p_bytes, p_ops)
    carried = PART_ROWS * (8 * k + 4)
    # rows: the 10 key bytes of each record in, ids out; and the floors
    # of the 32-byte sectors and the 64-byte memory atoms the keys touch
    r_bytes = PART_ROWS * (KEY + 4) + small
    r_bound, r_by = bound_ms(r_bytes, p_ops)
    sector = key_floor_bytes(data.data_ptr(), PART_ROWS, RECORD, KEY, 32) \
        + PART_ROWS * 4 + small
    atom = key_floor_bytes(data.data_ptr(), PART_ROWS, RECORD, KEY, 64) \
        + PART_ROWS * 4 + small
    sector_ms, atom_ms = bound_ms(sector, p_ops)[0], bound_ms(atom, p_ops)[0]
    print(f"kernel bucket_partition [{PART_ROWS}, {k}] n_buckets="
          f"{N_BUCKETS}: kernel_ms={words_ms:.4f} bound_ms={p_bound:.4f} "
          f"({p_bytes} bytes, 32-bit key words) carried_bytes={carried} "
          f"({carried / (words_ms * 1e-3) / 1e12:.3f} TB/s) "
          f"plain_ms={words_plain_ms:.4f} cases={n_cases} "
          f"max_abs_err={worst}")
    print(f"kernel bucket_partition_rows [{PART_ROWS}, {RECORD}] B k={k} "
          f"n_buckets={N_BUCKETS}: kernel_ms={rows_ms:.4f} "
          f"bound_ms={r_bound:.4f} ({r_bytes} bytes) "
          f"sector_floor_ms={sector_ms:.4f} ({sector} bytes) "
          f"atom_floor_ms={atom_ms:.4f} ({atom} bytes, "
          f"{atom / (rows_ms * 1e-3) / 1e12:.3f} TB/s, "
          f"{rows_ms / atom_ms:.2f}x the atom floor) "
          f"old_route_ms={old_ms:.4f} (key rows + words entry) "
          f"words_ms={words_ms:.4f} plain_ms={rows_plain_ms:.4f} "
          f"cases={n_rows} max_abs_err={worst_rows}")
    return (row("bucket_partition", worst, words_ms, words_plain_ms, p_bound,
                p_by),
            row("bucket_partition_rows", worst_rows, rows_ms, rows_plain_ms,
                r_bound, r_by))


def assign_phase(torch):
    """Both kmeans_assign entries against their plain versions; returns
    their two rows."""
    from repro_torch.kernels.kmeans_assign import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    worst = worst_p = 0.0
    n_cases = n_partials = 0

    def case(n, d, k, dtype, dup=False):
        x = torch.randn((n, d), generator=gen).to(dtype).to(dev)
        c = torch.randn((k, d), generator=gen)
        if dup and k > 2:
            c[k - 1] = c[1]
        return x, c.to(dev)

    def decided_points(x, c, want_ids):
        """Points whose plain best-to-second gap exceeds the margin, the
        ones whose id must agree exactly."""
        x32 = x.float()
        xx = (x32 * x32).sum(1)
        cc = (c * c).sum(1)
        scale = xx + cc[want_ids.long()]
        if c.shape[0] < 2 or not x.shape[0]:
            return torch.ones_like(want_ids, dtype=torch.bool), scale
        full = xx[:, None] - 2 * (x32 @ c.T) + cc[None]
        two = full.topk(2, dim=1, largest=False).values
        return two[:, 1] - two[:, 0] > 1e-5 * scale, scale

    def compare(x, c, bn=1024):
        nonlocal worst, n_cases
        ids, d2 = kernel.kmeans_assign_ids(x, c, bn=bn)
        want_ids, want_d2 = ref.kmeans_assign_ref(x, c)
        decided, scale = decided_points(x, c, want_ids)
        if x.shape[0]:
            err = (d2 - want_d2).abs()
            worst = max(worst, float(err.max()))
            check(bool(torch.all(err <= 1e-5 * scale + 1e-6)),
                  f"kmeans_assign d2 beyond tolerance {tuple(x.shape)} "
                  f"K={c.shape[0]} {x.dtype}: max err {float(err.max())}")
        bad = int((ids[decided] != want_ids[decided]).sum())
        check(bad == 0, f"kmeans_assign ids differ at {bad} decided points "
                        f"{tuple(x.shape)} K={c.shape[0]} {x.dtype}")
        got = ops.kmeans_assign(x, c, block_n=bn)
        check(torch.equal(got[0], ids) and torch.equal(got[1], d2),
              "ops.kmeans_assign differs from the kernel")
        n_cases += 1
        return ids

    def compare_partials(x, c, valid):
        """The fused partials: the same bits twice; counts exactly the
        masked bincount of the ids kernel's ids and sums within 1e-5 *
        sum |x| + 1e-6 of float64 one-hot sums over them; and, over the
        decided points, counts equal to the plain version's and sums
        within the same bound of them."""
        nonlocal worst_p, n_partials
        k, d = c.shape
        where = f"{tuple(x.shape)} K={k} {x.dtype} mask={valid is not None}"
        table = kernel.kmeans_partials(x, c, valid)
        check(torch.equal(table, kernel.kmeans_partials(x, c, valid)),
              f"kmeans_partials differs between two launches {where}")
        check(torch.equal(table, ops.kmeans_partials(x, c, valid)),
              "ops.kmeans_partials differs from the kernel")
        ids, _ = kernel.kmeans_assign_ids(x, c, bn=1024)
        v = (torch.ones(x.shape[0], dtype=torch.bool, device=dev)
             if valid is None else valid)
        check(torch.equal(table[:, d], torch.bincount(
            ids[v].long(), minlength=k).float()),
            f"kmeans_partials counts differ from the ids kernel's {where}")
        oh = torch.nn.functional.one_hot(ids.long(), k).double() \
            * v.double()[:, None]
        err = (table[:, :d].double() - oh.T @ x.double()).abs()
        check(bool(torch.all(err <= 1e-5 * (oh.T @ x.double().abs())
                             + 1e-6)),
              f"kmeans_partials sums beyond tolerance {where}: max err "
              f"{float(err.max()) if err.numel() else 0.0}")
        want_ids, _ = ref.kmeans_assign_ref(x, c)
        sure = v & decided_points(x, c, want_ids)[0]
        got = kernel.kmeans_partials(x, c, sure)
        plain = ref.kmeans_partials_ref(x, c, sure)
        check(torch.equal(got[:, d], plain[:, d]),
              f"kmeans_partials counts differ from the plain version "
              f"{where}")
        oh = torch.nn.functional.one_hot(want_ids.long(), k).float() \
            * sure.float()[:, None]
        p_err = (got[:, :d] - plain[:, :d]).abs()
        check(bool(torch.all(p_err <= 1e-5 * (oh.T @ x.float().abs())
                             + 1e-6)),
              f"kmeans_partials sums differ from the plain version {where}")
        if p_err.numel():
            worst_p = max(worst_p, float(p_err.max()))
        n_partials += 1

    for dtype in (torch.float32, torch.bfloat16):
        for n, d, k, bn in ((0, 8, 10, 1024), (1, 1, 1, 1024),
                            (100_003, 8, 10, 1024), (65_536, 32, 100, 512),
                            (777, 3, 5, 7), (5000, 16, 7, 256),
                            (3000, 40, 6, 64), (2000, 8, 200, 1024)):
            x, c = case(n, d, k, dtype, dup=True)
            ids = compare(x, c, bn)
            check(k <= 2 or not bool((ids == k - 1).any()),
                  "a duplicated centroid won over its lower twin")
            compare_partials(x, c, None)
            compare_partials(x, c, torch.rand(n, generator=gen).to(dev)
                             < 0.7)
    # 16-byte misaligned points: the element-wise load route
    x, c = case(100_001, 8, 10, torch.float32)
    odd = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    odd.copy_(x)
    check(all(torch.equal(g, w) for g, w in zip(
        kernel.kmeans_assign_ids(odd, c, bn=1024),
        kernel.kmeans_assign_ids(x, c, bn=1024))),
        "misaligned points change the ids kernel's output")
    # the element route walks the points in another order, so only the
    # counts are bit for bit
    check(torch.equal(kernel.kmeans_partials(odd, c)[:, DIM],
                      kernel.kmeans_partials(x, c)[:, DIM]),
          "misaligned points change the partials' counts")
    compare(odd, c)
    compare_partials(odd, c, None)
    # the shared-memory limit: exactly full runs, one float more raises
    kd = (256, 226)
    check(kernel.shared_bytes(*kd) == kernel.MAX_SHARED,
          "the limit case does not fill shared memory")
    x, c = case(4096, kd[1], kd[0], torch.float32)
    compare(x, c)
    compare_partials(x, c, torch.rand(4096, generator=gen).to(dev) < 0.7)
    x, c = case(64, kd[1] + 1, kd[0], torch.float32)
    for entry in (lambda: kernel.kmeans_assign_ids(x, c, bn=1024),
                  lambda: kernel.kmeans_partials(x, c)):
        try:
            entry()
        except ValueError:
            pass
        else:
            fail("kmeans_assign took a centroid table over the shared "
                 "memory")
    torch.cuda.synchronize()

    # the path's launch shape: one 64 MiB chunk of points, K=10, every
    # row valid (a full chunk)
    x, c = case(ASSIGN_ROWS, DIM, K, torch.float32)
    valid = torch.ones(ASSIGN_ROWS, dtype=torch.bool, device=dev)
    compare(x, c)
    compare_partials(x, c, valid)
    kernel_ms = timed_ms(torch, lambda: kernel.kmeans_assign_ids(
        x, c, bn=1024))
    plain_ms = timed_ms(torch, lambda: ref.kmeans_assign_ref(x, c))
    part_ms = timed_ms(torch, lambda: kernel.kmeans_partials(x, c, valid))
    part_plain_ms = timed_ms(torch, lambda: ref.kmeans_partials_ref(
        x, c, valid))
    # |x|^2 and x.c as FMAs (2 operations each), and the compare-and-add
    a_ops = ASSIGN_ROWS * (2 * DIM * (K + 1) + 2 * K)
    # ids: points and centroids in, ids and d2 out
    a_bytes = x.nbytes + c.nbytes + ASSIGN_ROWS * 8
    a_bound, a_by = bound_ms(a_bytes, a_ops)
    # partials: points, mask and centroids in, [K, D + 1] out; and the
    # D + 1 adds of each point into its centroid's cells
    p_bytes = x.nbytes + valid.nbytes + c.nbytes + K * (DIM + 1) * 4
    p_ops = a_ops + ASSIGN_ROWS * 2 * (DIM + 1)
    p_bound, p_by = bound_ms(p_bytes, p_ops)
    print(f"kernel kmeans_assign [{ASSIGN_ROWS}, {DIM}] K={K}: "
          f"kernel_ms={kernel_ms:.4f} bound_ms={a_bound:.4f} "
          f"({a_bytes} bytes, {a_ops} operations) "
          f"({a_bytes / (kernel_ms * 1e-3) / 1e12:.3f} TB/s, "
          f"{kernel_ms / a_bound:.2f}x the bound) "
          f"plain_ms={plain_ms:.4f} cases={n_cases} max_abs_err={worst:.3e}")
    print(f"kernel kmeans_partials [{ASSIGN_ROWS}, {DIM}] K={K}: "
          f"kernel_ms={part_ms:.4f} bound_ms={p_bound:.4f} "
          f"({p_bytes} bytes, {p_ops} operations) "
          f"({p_bytes / (part_ms * 1e-3) / 1e12:.3f} TB/s, "
          f"{part_ms / p_bound:.2f}x the bound) "
          f"plain_ms={part_plain_ms:.4f} cases={n_partials} "
          f"max_abs_err={worst_p:.3e}")
    return (row("kmeans_assign", worst, kernel_ms, plain_ms, a_bound, a_by),
            row("kmeans_partials", worst_p, part_ms, part_plain_ms, p_bound,
                p_by))


# ------------------------------------------------------------ phase 3
def terasort_data(n_records: int, seed: int):
    """(records [n, 100] uint8 from ``seed``, oracle order): the oracle is
    a stable lexsort of the 10-byte keys, which must have no ties (so the
    sorted order is unique)."""
    rng = np.random.default_rng(seed)
    data = np.frombuffer(rng.bytes(n_records * RECORD), np.uint8) \
        .reshape(n_records, RECORD)
    k_hi = data[:, :8].copy().view(">u8")[:, 0]
    k_lo = data[:, 8:10].copy().view(">u2")[:, 0]
    order = np.lexsort((k_lo, k_hi))
    ties = (k_hi[order][1:] == k_hi[order][:-1]) \
        & (k_lo[order][1:] == k_lo[order][:-1])
    check(not ties.any(), "random keys have ties; pick another --seed")
    return data, order


def terasort_path(torch, n_records: int, seed: int, device="cuda", mesh=None,
                  label="terasort", verbose=True,
                  chunk_records=CHUNK_RECORDS, tracer=None):
    """TeraSort through the port's engine (on ``mesh`` when given), in a
    cloud of ``chunk_records``-record chunks, its spans recorded in
    ``tracer`` (a fresh ``Tracer`` by default).  Returns (launches
    {kernel name: count} of the run, report, outputs, data, oracle order,
    boundaries, run wall seconds, shuffle paths)."""
    say = print if verbose else (lambda *a, **k: None)
    from repro_torch.core import SphereEngine, SphereJob
    from repro_torch.core.shuffle import sample_boundaries, terasort_stages
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels.bucket_partition import kernel

    t = time.perf_counter()
    data, order = terasort_data(n_records, seed)
    say(f"{label}: data + oracle {time.perf_counter() - t:.2f}s")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        master, client = cloud(tmp, chunk_records * RECORD)
        t = time.perf_counter()
        client.upload("tera", data.tobytes(), replication=3)
        upload_s = time.perf_counter() - t
        step = max(1, n_records // 100_000)
        sample = [data[i, :KEY].tobytes() for i in range(0, n_records, step)]
        bounds = sample_boundaries(sample, N_BUCKETS, key_bytes=KEY)
        job = SphereJob("terasort", "tera",
                        terasort_stages(bounds, "array", N_BUCKETS, KEY),
                        record_size=RECORD, backend="array")
        tracer = Tracer() if tracer is None else tracer
        engine = SphereEngine(master, client,
                              device=None if mesh is not None else device,
                              timing_sync=True, tracer=tracer, mesh=mesh)
        on_card = engine.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernel.launches = kernel.rows_launches = 0
        t = time.perf_counter()
        outs, rep = engine.run(job)
        if on_card:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = {"bucket_dest": kernel.launches,
                    "bucket_partition_rows": kernel.rows_launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    paths = sorted({sp.attrs.get("path") for sp in tracer.snapshot()
                    if sp.name == "shuffle-round"})
    say(f"{label}: {n_records} records x {RECORD} B: "
          f"upload_s={upload_s:.3f} run_wall_s={wall_s:.3f} "
          f"partition_seconds={rep.partition_seconds:.4f} "
          f"rec_per_s={n_records / wall_s:.0f} "
          f"sim_seconds={rep.sim_seconds:.3f} "
          f"max_memory_allocated={peak} "
          f"shuffle_rounds={rep.shuffle_rounds} host_syncs={rep.host_syncs} "
          f"device_dispatches={rep.device_dispatches} "
          f"udf_traces={rep.udf_traces} launches={launches} "
          f"shuffle paths={paths}")
    say(f"{label}: host-clock spans (s): {spans_line(tracer)}")
    return launches, rep, outs, data, order, bounds, wall_s, paths


def check_terasort(launches, rep, outs, data, order) -> bytes:
    check(rep.shuffle_rounds >= 1, "the job ran no shuffle round")
    check(launches == rep.shuffle_rounds,
          f"bucket_dest launched {launches} times for "
          f"{rep.shuffle_rounds} shuffle rounds")
    check(rep.host_syncs == rep.shuffle_rounds,
          f"host_syncs {rep.host_syncs} != shuffle_rounds "
          f"{rep.shuffle_rounds}")
    check(len(outs) == N_BUCKETS, f"{len(outs)} output partitions")
    got = b"".join(outs)
    check(len(got) == data.nbytes, f"{len(got)} output bytes, expected "
                                   f"{data.nbytes}")
    want = data[order].tobytes()
    check(got == want, "sorted output differs from the numpy oracle")
    return want


# ------------------------------------------------------------ phase 4
def partition_path(torch, data, bounds, device="cuda"):
    """partition_batch and shuffle_batch on the TeraSort records.  Returns
    ((rows entry, words entry) launches, calls, ids, hist, pieces' sorted
    bytes)."""
    from repro_torch.core.records import RecordBatch
    from repro_torch.core.shuffle import (partition_batch, range_partitioner,
                                          shuffle_batch)
    from repro_torch.kernels.bucket_partition import kernel

    batch = RecordBatch.from_bytes(data.tobytes(), RECORD, device=device)
    part = range_partitioner(bounds)
    if device == "cuda":
        torch.cuda.synchronize()
    kernel.rows_launches = kernel.partition_launches = 0
    t = time.perf_counter()
    ids, hist = partition_batch(batch, part, N_BUCKETS)
    pieces = shuffle_batch(batch, part, N_BUCKETS)
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = (kernel.rows_launches, kernel.partition_launches)
    t = time.perf_counter()
    sorted_bytes = b"".join(p.sort_by_key(KEY).to_bytes() for p in pieces)
    print(f"partition_batch + shuffle_batch: {batch.num_records} records: "
          f"wall_s={wall_s:.4f} hist={hist.tolist()} launches={launches} "
          f"(sort check {time.perf_counter() - t:.2f}s)")
    del pieces
    if device == "cuda":
        profile_partition(torch, batch, part)
    return launches, 2, ids.cpu().numpy(), hist.cpu().numpy(), sorted_bytes


def profile_partition(torch, batch, part) -> None:
    """One partition_batch under ``torch.profiler`` beside the route it
    replaced (the key rows built by plain torch, then the words entry),
    each after a warm call: device busy time against the host clock of
    the call, and the largest device consumers; then shuffle_batch's host
    steps (``records.scatter_by_ids``) timed one by one.  A measurement
    only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.records import extract_keys
    from repro_torch.core.shuffle import _bounds_tensor, partition_batch
    from repro_torch.kernels.bucket_partition import ops

    def words_route():
        spec, bwords = part.scatter_spec(batch, N_BUCKETS)
        return ops.bucket_partition(extract_keys(batch.data, spec),
                                    _bounds_tensor(bwords, batch.device),
                                    n_buckets=N_BUCKETS)

    for name, fn in (("words route (key rows + words entry)", words_route),
                     ("partition_batch (rows entry)",
                      lambda: partition_batch(batch, part, N_BUCKETS))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
        if not busy_ms:
            print(f"partition: profiled {name}: the profiler saw no device "
                  f"time; device busy share not measured")
            continue
        top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
        print(f"partition: profiled {name}: {wall_ms:.3f} ms on the host "
              f"clock, device busy {busy_ms:.3f} ms (idle share "
              f"{1 - busy_ms / wall_ms:.3f}) in "
              f"{sum(e.count for e in on_card)} device ops; largest: "
              + "; ".join(f"{e.key[:50]} x{e.count} "
                          f"{e.self_device_time_total / 1e3:.3f} ms"
                          for e in top))

    ids, hist = partition_batch(batch, part, N_BUCKETS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids_np, hist_np = ids.cpu().numpy(), hist.cpu().numpy()
    t1 = time.perf_counter()
    order = np.argsort(ids_np, kind="stable")
    t2 = time.perf_counter()
    pieces = [batch.take(p)
              for p in np.split(order, np.cumsum(hist_np)[:-1])]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"partition: shuffle_batch's host steps: ids and hist to the host "
          f"{t1 - t0:.4f} s, stable argsort of {len(ids_np)} ids "
          f"{t2 - t1:.4f} s, {len(pieces)} takes {t3 - t2:.4f} s")


def check_partition(launches, calls, ids, hist, sorted_bytes, data, bounds,
                    outs, want) -> None:
    check(launches[0] == calls, f"bucket_partition_rows launched "
                                f"{launches[0]} times for {calls} calls")
    check(launches[1] == 0, f"the partition path launched the words entry "
                            f"{launches[1]} times")
    key_hi = data[:, :8].copy().view(">u8")[:, 0]
    key_lo = data[:, 8:10].copy().view(">u2")[:, 0]
    oracle = np.zeros(len(data), np.int64)
    for b in bounds:
        b_hi = np.frombuffer(b[:8], ">u8")[0]
        b_lo = np.frombuffer(b[8:10], ">u2")[0]
        oracle += (b_hi < key_hi) | ((b_hi == key_hi) & (b_lo < key_lo))
    check(np.array_equal(ids, np.minimum(oracle, N_BUCKETS - 1)),
          "partition_batch ids differ from the numpy oracle")
    counts = [len(o) // RECORD for o in outs]
    check(hist.tolist() == counts, f"partition_batch hist {hist.tolist()} "
                                   f"!= TeraSort bucket counts {counts}")
    check(sorted_bytes == want,
          "shuffle_batch pieces, sorted, differ from the oracle order")


# ------------------------------------------------------------ phase 5
def make_points(torch, n_points: int, seed: int, device="cuda"
                ) -> np.ndarray:
    """A mixture of K Gaussian clusters, float32, drawn on ``device`` from
    ``seed`` a slice at a time (numpy on the host of an NVIDIA H100
    80GB HBM3 machine took 19 s for 100M points), returned on the
    host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((K, DIM), generator=gen, device=device) * 4.0
    pts = np.empty((n_points, DIM), np.float32)
    step = 1 << 24
    for i in range(0, n_points, step):
        m = min(step, n_points - i)
        ids = torch.randint(0, K, (m,), generator=gen, device=device)
        pts[i:i + m] = (centers[ids] + torch.randn(
            (m, DIM), generator=gen, device=device)).cpu().numpy()
    return pts


def lloyd_oracle(torch, pts: np.ndarray, seed: int, iters: int,
                 device="cuda") -> np.ndarray:
    """Float64 Lloyd iterations from kmeans_sphere's seeded init, with its
    keep-empty-centroid rule, in plain PyTorch on ``device`` (no kernel of
    the port): the points copied there once in float32, each slice's
    distances and sums in float64; the argmin keeps the lowest index on
    a tie, as the kernel does."""
    c = np.random.default_rng(seed).normal(size=(K, DIM)).astype(np.float32)
    x32 = torch.from_numpy(pts).to(device)
    step = 1 << 23
    for _ in range(iters):
        c64 = torch.from_numpy(c.astype(np.float64)).to(device)
        sums = torch.zeros((K, DIM), dtype=torch.float64, device=device)
        counts = torch.zeros(K, dtype=torch.float64, device=device)
        for i in range(0, len(pts), step):
            x = x32[i:i + step].double()
            # |x|^2 is common to a row
            a = ((c64 * c64).sum(1) - 2 * (x @ c64.T)).argmin(1)
            sums.index_add_(0, a, x)
            counts += torch.bincount(a, minlength=K)
        nz = counts > 0
        c[nz.cpu().numpy()] = (sums[nz] / counts[nz, None]).cpu().numpy() \
            .astype(np.float32)
    return c


def profile_iteration(torch, engine, session, cents, steady_s: float
                      ) -> None:
    """One more k-means iteration in the same session, under
    ``torch.profiler``: the device's busy time per steady iteration (the
    sum of its kernels and copies on the one stream), its idle share
    against the median unprofiled iteration, and the largest device
    consumers.  A measurement only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.kmeans import kmeans_sphere
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kmeans_sphere(engine, "angle/points.f32", dim=DIM, k=K, iters=1,
                      backend="array", session=session, init=cents)
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if not busy_ms:
        print("kmeans: profiled iteration: the profiler saw no device "
              "time; device busy share not measured")
        return
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    print(f"kmeans: profiled iteration: device busy {busy_ms:.3f} ms "
          f"against a steady iteration of {steady_s * 1e3:.3f} ms "
          f"(idle share {1 - busy_ms / (steady_s * 1e3):.3f}); largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms"
                      for e in top))


def kmeans_path(torch, n_points: int, seed: int, device="cuda"):
    """k-means through one session.  Returns ((kmeans_partials,
    kmeans_assign) launches, assign tasks a run, centroids, report,
    points)."""
    from repro_torch.core import SphereEngine
    from repro_torch.core.kmeans import encode_points, kmeans_sphere
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels.kmeans_assign import kernel

    t = time.perf_counter()
    pts = make_points(torch, n_points, seed, device)
    print(f"kmeans: data {time.perf_counter() - t:.2f}s")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_km_"))
    try:
        master, client = cloud(tmp)
        t = time.perf_counter()
        client.upload("angle/points.f32", encode_points(pts), replication=2)
        upload_s = time.perf_counter() - t
        n_chunks = master.files["angle/points.f32"].n_chunks
        tracer = Tracer()
        engine = SphereEngine(master, client, device=device, tracer=tracer)
        session = engine.session("angle/points.f32", record_size=4 * DIM,
                                 backend="array")
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernel.partials_launches = kernel.launches = 0
        iter_s: list = []
        t = time.perf_counter()
        cents, rep = kmeans_sphere(engine, "angle/points.f32", dim=DIM, k=K,
                                   iters=ITERS, seed=seed, backend="array",
                                   session=session, iter_seconds=iter_s)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = (kernel.partials_launches, kernel.launches)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        spans = spans_line(tracer)
        if device == "cuda":
            profile_iteration(torch, engine, session, cents,
                              statistics.median(iter_s[1:]))
        session.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steady = sum(iter_s[1:])
    print(f"kmeans: {n_points} points x {DIM} K={K} iters={ITERS} "
          f"chunks={n_chunks}: upload_s={upload_s:.3f} "
          f"run_wall_s={wall_s:.3f} iter_s="
          f"{[round(s, 4) for s in iter_s]} "
          f"points_per_s_iters_1_4="
          f"{n_points * (ITERS - 1) / steady if steady else 0:.0f} "
          f"sim_seconds={rep.sim_seconds:.3f} max_memory_allocated={peak} "
          f"tasks={rep.tasks} shuffle_rounds={rep.shuffle_rounds} "
          f"host_syncs={rep.host_syncs} "
          f"device_dispatches={rep.device_dispatches} "
          f"udf_traces={rep.udf_traces} launches={launches}")
    print(f"kmeans: host-clock spans (s): {spans}")
    return launches, n_chunks, cents, rep, pts


def check_kmeans(torch, launches, n_chunks, cents, rep, pts, seed,
                 device="cuda") -> float:
    check(rep.udf_traces == {"assign": 1, "fold": 1},
          f"udf_traces {rep.udf_traces}")
    check(launches[0] == ITERS * n_chunks,
          f"kmeans_partials launched {launches[0]} times for {ITERS} "
          f"iterations x {n_chunks} assign tasks")
    check(launches[1] == 0, f"the k-means path launched the ids kernel "
                            f"{launches[1]} times")
    t = time.perf_counter()
    want = lloyd_oracle(torch, pts, seed, ITERS, device)
    err = float(np.abs(cents - want).max())
    print(f"kmeans: oracle {time.perf_counter() - t:.2f}s, centroids max "
          f"abs err {err:.3e}")
    check(np.allclose(cents, want, rtol=1e-3, atol=1e-3),
          f"k-means centroids differ from the float64 oracle (max abs "
          f"err {err})")
    return err


# ------------------------------------------------------------ phases 6-7
@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def plain_kernels():
    """Both LM kernels' launchers swapped for their plain versions (the
    scan's backward launcher too): the reference runs of the logit check
    and of the gradient check, set up here and nowhere else."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.kernels.rg_lru_scan.ref import lru_scan_ref

    def attn(q, k, v, *, causal, window):
        return flash_attention_ref(q, k, v, causal=causal, window=window)

    with patched(fkernel, "flash_attention_fwd", attn), \
            patched(lkernel, "lru_scan", lru_scan_ref), \
            patched(lkernel, "lru_scan_backward", lru_scan_ref):
        yield


def lm_model(torch, seed: int, cfg=None, device="cuda"):
    """The LM config (default: recurrentgemma-2b's full config) and its
    parameters from ``seed`` on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_leaves
    cfg = cfg or get_config(LM_ARCH)
    t = time.perf_counter()
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               device)
    if device == "cuda":
        torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"lm: {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.param_dtype}: {n} parameters "
          f"({sum(p.nbytes for p in tree_leaves(params))} bytes) in "
          f"{time.perf_counter() - t:.2f}s")
    return cfg, params


def serve_prompts(cfg, seed: int, long=LONG_PROMPTS, short=(16, 513)):
    """The long prompts, then six lengths drawn from ``seed`` in
    ``short``; tokens drawn from ``seed``."""
    rng = np.random.default_rng([seed, 3])
    lengths = list(long) + [int(n) for n in rng.integers(
        short[0], short[1], N_REQUESTS - len(long))]
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


@contextlib.contextmanager
def spying(torch, hooks):
    """Yields ``{label: (args, kwargs)}``, filled inside the block with
    each hooked call, its tensors cloned; ``hooks`` maps a label to
    ``(module, name)``, or to ``(module, name, n)`` for that function's
    call numbered n (from 0)."""
    got, seen = {}, {}

    def spy(label, real, n):
        def call(*args, **kw):
            if seen.setdefault(label, 0) == n:
                got[label] = (tuple(a.clone() if isinstance(a, torch.Tensor)
                                    else a for a in args), kw)
            seen[label] += 1
            return real(*args, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for label, (module, name, *n) in hooks.items():
            stack.enter_context(patched(module, name, spy(
                label, getattr(module, name), n[0] if n else 0)))
        yield got


def capture_calls(torch, cfg, params, prompt, hooks, max_len=SERVE_LEN,
                  extra=None):
    """One prefill of ``prompt`` (and the batch entries ``extra``: frames
    or patches) with ``hooks`` (:func:`spying`).  Returns ``{label:
    (args, kwargs)}`` of each hooked call, and prints the prefill's
    seconds."""
    from repro_torch.models import model
    dev = params["embed"]["w"].device
    with spying(torch, hooks) as got, torch.inference_mode():
        t = time.perf_counter()
        model.prefill(params, {"inputs": torch.tensor([prompt], device=dev),
                               **(extra or {})}, cfg=cfg, max_len=max_len)
        sync(torch, dev)
    print(f"lm: {cfg.name}: capture prefill of {len(prompt)} tokens (the "
          f"first, cold) {time.perf_counter() - t:.3f}s")
    return got


def capture_activations(torch, cfg, params, prompt, max_len=SERVE_LEN):
    """One prefill of ``prompt``; returns the inputs of its first
    ``flash_attention`` and first ``rg_lru_scan`` launch (the first L and
    the first R layer)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    got = capture_calls(torch, cfg, params, prompt, {
        "attn": (fkernel, "flash_attention_fwd"),
        "scan": (lkernel, "lru_scan")}, max_len)
    (q, k, v), kw = got["attn"]
    return {"attn": (q, k, v, kw["causal"], kw["window"]),
            "scan": got["scan"][0]}


def _sdpa_mask(torch, T, S, window, dev):
    tpos = torch.arange(T, device=dev)[:, None]
    spos = torch.arange(S, device=dev)[None, :]
    mask = spos <= tpos
    if window:
        mask &= tpos - spos < window
    return mask


def _rounded_p(torch, q, k, v, causal, window):
    """``(o, w)``, float32 ``[B, T, H, D]``: ``o`` as
    :func:`attention_rounded_p`; ``w = sum_j p_j |v_j| / l``, the size a
    one-bf16-step change of every p can move ``o`` by."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (x.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
              for x in (k, v))
    s = qf @ kf.transpose(2, 3) / math.sqrt(D)
    tpos = torch.arange(T, device=q.device)[:, None]
    spos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= spos <= tpos
    if window:
        mask &= tpos - spos < window
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vf) / l
    w = (p @ vf.abs()) / l
    return o.transpose(1, 2), w.transpose(1, 2)


def attention_rounded_p(torch, q, k, v, causal, window):
    """The bf16 flash kernel's numerics in plain PyTorch, float32 out:
    q ``[B, T, H, D]``, k / v ``[B, S, K, D]``; scores, the row maximum
    and the row sum in float32, masked scores -1e30; the unnormalised p
    (relative to the row maximum) rounded to v's type before its float32
    product with v, then divided by the sum of the unrounded p.  For
    float32 inputs it is the plain version's function."""
    return _rounded_p(torch, q, k, v, causal, window)[0]


def rounded_p_excess(torch, got, q, k, v, causal, window):
    """``(max |got - o|, excess)`` for the bf16 kernel's output ``got``
    against ``o`` of :func:`attention_rounded_p`.  The kernel rounds each
    p relative to its running maximum, the oracle relative to the row's,
    so a p may lie one bf16 step (2**-8 of it) apart, and the output
    rounds once more (2**-8 of it): ``excess`` is the largest
    ``|got - o| - 2**-8 * (|o| + w)``, what is left for float32 sums in
    another order.  Where a row's live keys lie in one 64-key tile the
    two maxima agree and ``|got - o| <= 2**-8 * |o|`` up to that."""
    o, w = _rounded_p(torch, q, k, v, causal, window)
    diff = (got.float() - o).abs()
    return (float(diff.max()),
            float((diff - 2 ** -8 * (o.abs() + w)).max()))


TILE_KEYS = 64                          # flash_attention.cu's kTcKeys


def _tile_p(torch, q, k, v, causal, window, heads: int = 8):
    """``(o, w)`` as :func:`_rounded_p`, with p rounded as the bf16 kernel
    rounds it: scores in log2 units (times ``log2(e) / sqrt(D)``), p
    relative to the row's running maximum after each ``TILE_KEYS``-key
    tile, tiles in ascending order, rounded to v's type before the
    product with v; the row sum of the unrounded p; each tile's part
    rescaled by ``2 ** (m_tile - m_row)``.  ``heads`` query heads at a
    time (the scores of 48 heads at 3,072 tokens are 1.8 GB)."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    n_tiles = -(-S // TILE_KEYS)
    pad = n_tiles * TILE_KEYS - S
    # the kernel's float32 product: scale * kLog2e
    scale_log2 = float(np.float32(1 / math.sqrt(D))
                       * np.float32(math.log2(math.e)))
    tpos = torch.arange(T, device=q.device)[:, None]
    spos = torch.arange(S, device=q.device)[None, :]
    live = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        live &= spos <= tpos
    if window:
        live &= tpos - spos < window
    outs, ws = [], []
    for h0 in range(0, H, heads):
        hs = range(h0, min(H, h0 + heads))
        qf = q[:, :, h0:hs[-1] + 1].float().transpose(1, 2)
        kv = [x[:, :, [h // (H // K) for h in hs]].float().transpose(1, 2)
              for x in (k, v)]
        sc = (qf @ kv[0].transpose(2, 3)) * scale_log2
        sc = sc.masked_fill(~live, -math.inf)
        tiles = torch.nn.functional.pad(sc, (0, pad), value=-math.inf) \
            .unflatten(-1, (n_tiles, TILE_KEYS))
        run = torch.cummax(tiles.amax(-1), dim=-1).values  # [.., T, tiles]
        row = run[..., -1:]
        m_key = run.repeat_interleave(TILE_KEYS, dim=-1)[..., :S]
        p = torch.exp2(sc - m_key).nan_to_num(0.0)   # -inf - -inf: no key
        rescale = torch.exp2(m_key - row).nan_to_num(0.0)
        l = (p * rescale).sum(-1, keepdim=True)
        outs.append((p.to(v.dtype).float() * rescale) @ kv[1] / l)
        ws.append((p * rescale) @ kv[1].abs() / l)
    return (torch.cat(outs, 1).transpose(1, 2),
            torch.cat(ws, 1).transpose(1, 2))


def attention_tile_p(torch, q, k, v, causal, window):
    """The bf16 flash kernel's numerics in plain PyTorch, float32 out, tile
    for tile (:func:`_tile_p`): where every row's live keys lie in one
    tile, :func:`attention_rounded_p`'s function."""
    return _tile_p(torch, q, k, v, causal, window)[0]


def tile_p_excess(torch, got, q, k, v, causal, window):
    """``(max |got - o|, excess)`` for the bf16 kernel's output ``got``
    against ``o`` of :func:`attention_tile_p`: ``excess`` is the largest
    ``|got - o| - 2**-8 * (|o| + w)`` (the output's rounding, and a p on
    a bf16 rounding edge that the kernel's float32 scores, summed in
    another order, round the other way)."""
    o, w = _tile_p(torch, q, k, v, causal, window)
    diff = (got.float() - o).abs()
    return (float(diff.max()),
            float((diff - 2 ** -8 * (o.abs() + w)).max()))


def check_attention(torch, q, k, v, causal, window):
    """The flash kernel against its plain version on (q, k, v): within
    2e-2 (bf16) / 2e-5 (float32), in bf16 also within what rounding allows
    (plus 1e-4) of ``attention_tile_p``, which rounds p tile for tile as
    the kernel does; ``ops.flash_attention`` is the kernel.  Returns (max
    error, bf16 max error against the tile oracle, its excess beyond what
    rounding allows, the excess against ``attention_rounded_p``) (0, -1,
    -1 in float32).  The last is printed, not held: that oracle rounds p
    relative to the row's maximum, and its allowance of one bf16 step of
    each p is exceeded where a row's weight sits on two or three keys and
    the two roundings of a p fall a step apart in opposite directions
    (``dbrx-132b``'s first layer: 1.03e-3 at one output of 18,874,368,
    within the two steps' bound; the kernel equals a float64 emulation of
    its tile loop there, rounded to bf16)."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    got = kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
    check(bool(torch.allclose(got.float(), want.float(), rtol=tol,
                              atol=tol)),
          f"flash_attention beyond tolerance {tuple(q.shape)} "
          f"{tuple(k.shape)} {q.dtype} causal={causal} window={window}: "
          f"max err {err}")
    err_t, excess, excess_row = 0.0, -1.0, -1.0
    if q.dtype == torch.bfloat16:
        err_t, excess = tile_p_excess(torch, got, q, k, v, causal, window)
        excess_row = rounded_p_excess(torch, got, q, k, v, causal,
                                      window)[1]
        check(excess <= 1e-4,
              f"flash_attention beyond what rounding allows of the "
              f"tile-rounded-p oracle {tuple(q.shape)} {tuple(k.shape)} "
              f"causal={causal} window={window}: max err {err_t}, "
              f"{excess} beyond")
    check(torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                          window=window), got),
          "ops.flash_attention differs from the kernel")
    return err, err_t, excess, excess_row


def attention_times(torch, q, k, v, causal, window):
    """(kernel ms, plain ms, SDPA ms, SDPA's max error against the
    plain version) of attention over (q, k, v), timed as in phase 2;
    SDPA is told ``is_causal`` or given the window's mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref
    ms = timed_ms(torch, lambda: kernel.flash_attention_fwd(
        q, k, v, causal=causal, window=window))
    plain = timed_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window))
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (_sdpa_mask(torch, q.shape[1], k.shape[1], window, q.device)
            if window else None)

    def lib():
        if mask is None:
            return F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True)
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - ref.flash_attention_ref(
        q, k, v, causal=causal, window=window).float()).abs().max())
    return ms, plain, timed_ms(torch, lib), lib_err


def flash_phase(torch, captured):
    """flash_attention against its plain version: a sweep of small cases,
    the captured local layer, random inputs at the local and the global
    shape; timings at both shapes."""
    from repro_torch.kernels.flash_attention.cost import flash_cost, \
        live_pairs
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    worst = worst_rounded = 0.0
    worst_excess = worst_row = -1.0
    n_cases = 0

    def compare(q, k, v, causal, window):
        nonlocal worst, worst_rounded, worst_excess, worst_row, n_cases
        err, err_r, excess, row = check_attention(torch, q, k, v, causal,
                                                  window)
        worst = max(worst, err)
        worst_rounded = max(worst_rounded, err_r)
        worst_excess = max(worst_excess, excess)
        worst_row = max(worst_row, row)
        n_cases += 1

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    for dtype in (torch.float32, torch.bfloat16):
        for B, T, S, H, K, D, causal, window in (
                (2, 64, 64, 2, 2, 32, True, 0), (2, 64, 64, 4, 2, 32, True, 24),
                (2, 50, 70, 2, 2, 32, False, 0),
                (2, 32, 96, 2, 1, 64, False, 24),
                (1, 333, 333, 10, 1, 256, True, 100),
                (1, 257, 257, 16, 2, 128, True, 0),
                (3, 1, 1, 4, 4, 16, True, 0), (1, 129, 129, 2, 1, 12, True, 0)):
            compare(rand((B, T, H, D), dtype), rand((B, S, K, D), dtype),
                    rand((B, S, K, D), dtype), causal, window)
    q, k, v, causal, window = captured["attn"]
    compare(q, k, v, causal, window)
    torch.cuda.synchronize()
    B, T, H, D = q.shape

    # the path's local layer: the captured activations
    ms, plain, lib, lib_err = attention_times(torch, q, k, v, causal, window)
    live = live_pairs(T, T, causal, window)
    f_ops, f_bytes = flash_cost(q.shape, k.shape, q.element_size(), causal,
                                window)
    f_bound, f_by = bound_ms(f_bytes, f_ops, PEAK_BF16_PER_S)
    fp32_floor = f_ops / PEAK_OPS_PER_S * 1e3
    print(f"kernel flash_attention local q {list(q.shape)} k/v "
          f"{list(k.shape)} {q.dtype} window={window}: kernel_ms={ms:.4f} "
          f"bound_ms={f_bound:.4f} ({live} live pairs, {f_ops} operations at "
          f"989 TFLOP/s bf16; {f_bytes} bytes) "
          f"fp32_rate_floor_ms={fp32_floor:.4f} "
          f"({f_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s) plain_ms={plain:.4f} "
          f"sdpa_ms={lib:.4f} (max err vs plain {lib_err:.3e}; "
          f"{lib / ms:.3f}x the kernel's speed) "
          f"cases={n_cases} max_abs_err={worst:.3e} "
          f"bf16_max_abs_err_vs_tile_rounded_p={worst_rounded:.3e} "
          f"(beyond what rounding allows: {worst_excess:.3e}; against the "
          f"row-rounded p: {worst_row:.3e})")
    # Qwen2.5-3B's global layer shape, random inputs
    gq, gk, gv = (rand(shape, torch.bfloat16) for shape in (
        (1, T, 16, 128), (1, T, 2, 128), (1, T, 2, 128)))
    compare(gq, gk, gv, True, 0)
    g_ms, g_plain, g_lib, g_lib_err = attention_times(torch, gq, gk, gv,
                                                      True, 0)
    g_ops, g_bytes = flash_cost(gq.shape, gk.shape, gq.element_size(), True,
                                0)
    g_bound, _ = bound_ms(g_bytes, g_ops, PEAK_BF16_PER_S)
    print(f"kernel flash_attention global q {list(gq.shape)} k/v "
          f"{list(gk.shape)} bf16 causal: kernel_ms={g_ms:.4f} "
          f"bound_ms={g_bound:.4f} ({g_ops} operations) "
          f"fp32_rate_floor_ms={g_ops / PEAK_OPS_PER_S * 1e3:.4f} "
          f"({g_ops / (g_ms * 1e-3) / 1e12:.2f} TFLOP/s) "
          f"plain_ms={g_plain:.4f} sdpa_ms={g_lib:.4f} (max err vs plain "
          f"{g_lib_err:.3e}; {g_lib / g_ms:.3f}x the kernel's speed); "
          f"all {n_cases} cases: max_abs_err={worst:.3e} "
          f"bf16_max_abs_err_vs_tile_rounded_p={worst_rounded:.3e} "
          f"(beyond what rounding allows: {worst_excess:.3e}; against the "
          f"row-rounded p: {worst_row:.3e})")
    return row("flash_attention", worst, ms, plain, f_bound, f_by, lib)


def lru_phase(torch, captured):
    """rg_lru_scan against its plain version, exactly: small cases, the
    captured first R layer of the long prefill and a decode step;
    timings at the prefill and the decode shape."""
    from repro_torch.kernels.rg_lru_scan import kernel, ops, ref
    from repro_torch.kernels.rg_lru_scan.cost import scan_cost
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    n_cases = 0

    def compare(a, b, h0):
        nonlocal n_cases
        got = kernel.lru_scan(a, b, h0)
        want = ref.lru_scan_ref(a, b, h0)
        for name, g, w in zip(("h", "h_last"), got, want):
            err = float((g - w).abs().max()) if g.numel() else 0.0
            check(err == 0, f"rg_lru_scan {name} differs from the plain "
                            f"version {tuple(a.shape)}: max err {err}")
        check(all(torch.equal(x, y) for x, y in
                  zip(ops.rg_lru_scan(a, b, h0), got)),
              "ops.rg_lru_scan differs from the kernel")
        n_cases += 1

    def rand(B, T, W):
        a = torch.rand((B, T, W), generator=gen) * 0.299 + 0.7
        b = torch.randn((B, T, W), generator=gen) * 0.1
        return a.to(dev), b.to(dev), torch.randn((B, W), generator=gen).to(dev)

    for shape in ((1, 16, 32), (2, 33, 64), (3, 8, 48), (1, 13, 1000),
                  (4, 1, 2560), (2, 0, 8), (2, 63, 48), (1, 64, 2560),
                  (3, 65, 1000), (1, 200, 13)):
        compare(*rand(*shape))
    a, b, h0 = captured["scan"]
    compare(a, b, h0)
    torch.cuda.synchronize()
    out = {}
    for label, args in (("prefill", (a, b, h0)),
                        ("decode", rand(4, 1, a.shape[2]))):
        ms = timed_ms(torch, lambda: kernel.lru_scan(*args))
        plain = timed_ms(torch, lambda: ref.lru_scan_ref(*args))
        x = args[0]
        n_ops, n_bytes = scan_cost(x.shape)
        bnd, by = bound_ms(n_bytes, n_ops)
        out[label] = (ms, plain, bnd, by)
        print(f"kernel rg_lru_scan {label} {list(x.shape)}: "
              f"kernel_ms={ms:.4f} bound_ms={bnd:.6f} ({n_bytes} bytes) "
              f"({n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
              f"{ms / bnd:.2f}x the bound) plain_ms={plain:.4f}"
              + (f" cases={n_cases} max_abs_err=0" if label == "prefill"
                 else ""))
    ms, plain, bnd, by = out["prefill"]
    return row("rg_lru_scan", 0.0, ms, plain, bnd, by)


def serve_path(torch, cfg, params, prompts, max_len=SERVE_LEN,
               max_new=MAX_NEW, slots=SERVE_SLOTS, device="cuda",
               frames=None):
    """The requests through the port's ServeEngine (an encoder-decoder's
    with ``frames``, one array a request), one host-clock time per step.
    Returns (engine, requests, [(seconds, admitted, active)],
    (flash_attention, rg_lru_scan) launches, [(prompt length, last
    prefill logits)], peak device memory)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.models import model
    from repro_torch.serve import SamplerConfig, ServeEngine

    eng = ServeEngine(cfg, params, max_batch=slots, max_len=max_len,
                      scfg=SamplerConfig(temperature=0.0), device=device)
    last_logits = []
    real_prefill = model.prefill

    def prefill(params, batch, **kw):
        logits, cache = real_prefill(params, batch, **kw)
        last_logits.append((batch["inputs"].shape[1],
                            logits[0].float().cpu()))
        return logits, cache

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps = []
    fkernel.launches = 0
    lkernel.launches = 0
    with patched(model, "prefill", prefill):
        reqs = [eng.submit(p, max_new=max_new, enc_frames=f) for p, f in
                zip(prompts, frames or [None] * len(prompts))]
        while eng.queue or any(r is not None for r in eng.slot_req):
            queued = len(eng.queue)
            t = time.perf_counter()
            active = eng.step()
            steps.append((time.perf_counter() - t, queued - len(eng.queue),
                          active))
    launches = (fkernel.launches, lkernel.launches)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return eng, reqs, steps, launches, last_logits, peak


def report_serve(reqs, steps, launches, peak) -> float:
    """Print the serving metrics; returns the median steady step's
    seconds."""
    prefill_s = [r.t_first - r.t_admit for r in reqs]
    steady = [(sec, act) for sec, adm, act in steps if adm == 0]
    steady_s = sum(sec for sec, _ in steady)
    print(f"serve: {len(reqs)} requests x {reqs[0].max_new} new tokens, "
          f"prompts {[len(r.prompt) for r in reqs]}, {len(steps)} decode "
          f"steps ({len(steady)} steady): "
          f"ttft_long_s={reqs[0].t_first - reqs[0].t_submit:.4f} "
          f"(prompt {len(reqs[0].prompt)}) prefill_s="
          f"{[round(s, 4) for s in prefill_s]} prefill_tok_per_s="
          f"{sum(len(r.prompt) for r in reqs) / sum(prefill_s):.1f} "
          f"decode_tok_per_s_steady="
          f"{sum(act for _, act in steady) / steady_s:.1f} "
          f"steady_step_ms_median="
          f"{statistics.median(s for s, _ in steady) * 1e3:.3f} "
          f"max_memory_allocated={peak} launches flash_attention="
          f"{launches[0]} rg_lru_scan={launches[1]}")
    return statistics.median(sec for sec, _ in steady)


def flash_per_prefill(cfg) -> int:
    """``flash_attention`` launches of one prefill: one per attention
    layer, and for an encoder-decoder one per encoder layer and two per
    decoder layer (self and cross)."""
    per_unit = sum(s in "AL" for s in cfg.block_pattern)
    n = cfg.n_groups * per_unit
    if cfg.is_encoder_decoder:
        n = 2 * n + cfg.n_enc_layers // cfg.pattern_len * per_unit
    return n


def check_serve(cfg, eng, reqs, steps, launches, max_new=MAX_NEW) -> None:
    for r in reqs:
        check(r.done and len(r.out) == max_new,
              f"request {r.rid} finished {r.done} with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"request {r.rid} has tokens outside the vocabulary")
    check(all(s is None for s in eng.slot_req), "a slot was not recycled")
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    want = (flash_per_prefill(cfg) * len(reqs),
            n_rec * (len(reqs) + len(steps)))
    check(launches == want,
          f"launches (flash_attention, rg_lru_scan) {launches}, expected "
          f"{want} for {len(reqs)} prefills and {len(steps)} decode steps")


def check_logits(torch, cfg, params, prompts, last_logits,
                 max_len=SERVE_LEN) -> float:
    """The long prompts' last prefill logits against a reference prefill
    with both kernels swapped for their plain versions."""
    from repro_torch.models import model
    served = dict(last_logits)
    worst = 0.0
    dev = params["embed"]["w"].device
    for prompt in prompts[:len(LONG_PROMPTS)]:
        with plain_kernels(), torch.inference_mode():
            t = time.perf_counter()
            want, _ = model.prefill(
                params, {"inputs": torch.tensor([prompt], device=dev)},
                cfg=cfg, max_len=max_len)
            want = want[0].float().cpu()
            sec = time.perf_counter() - t
        got = served[len(prompt)]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        worst = max(worst, err / scale)
        print(f"serve: prompt {len(prompt)}: last logits vs the plain "
              f"reference max abs diff {err:.4e} (scale {scale:.4e}, "
              f"ratio {err / scale:.3e}, tolerance {LOGIT_TOL}); argmax "
              f"{int(got.argmax())} vs {int(want.argmax())}; reference "
              f"prefill {sec:.2f}s")
        check(err <= LOGIT_TOL * scale,
              f"prompt {len(prompt)}: served logits differ from the plain "
              f"reference by {err} (scale {scale})")
    return worst


def kernel_times(torch, prof):
    """[(name, launches, device ms)] of a finished ``torch.profiler`` run,
    largest first, summed from its raw events: a prefill of the xLSTM
    launches about a million kernels, and building ``key_averages()``'s
    per-event objects for them took minutes."""
    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, ns = totals.get(e.name(), (0, 0))
            totals[e.name()] = (n + 1, ns + e.duration_ns())
    return sorted(((name, n, ns / 1e6) for name, (n, ns) in totals.items()),
                  key=lambda t: -t[2])


def profile_decode(torch, eng, steady_s: float) -> None:
    """One more steady decode step over four short requests, under
    ``torch.profiler``: the device's busy time, its idle share against
    the served run's median steady step, and the largest consumers.  A
    measurement only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    for _ in range(eng.max_batch):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, 16).tolist(),
                   max_new=8)
    eng.step()                      # admit the four
    eng.step()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    eng.run()
    on_card = kernel_times(torch, prof)
    busy_ms = sum(ms for _, _, ms in on_card)
    if not busy_ms:
        print("serve: profiled decode step: the profiler saw no device "
              "time; device busy share not measured")
        return
    print(f"serve: profiled decode step ({eng.max_batch} active): device "
          f"busy {busy_ms:.3f} ms against a steady step of "
          f"{steady_s * 1e3:.3f} ms (idle share "
          f"{1 - busy_ms / (steady_s * 1e3):.3f}; the profiled step took "
          f"{wall * 1e3:.3f} ms); largest: "
          + "; ".join(f"{name[:50]} x{n} {ms:.3f} ms"
                      for name, n, ms in on_card[:8]))


def profile_prefill(torch, cfg, params, prompt, max_len=SERVE_LEN,
                    extra=None, key=None) -> None:
    """One more prefill of ``prompt`` (with the batch entries ``extra``,
    after a warm one) under ``torch.profiler``: the device's busy time
    against the host clock, and the device time of the largest kernels.
    A measurement only: the checked run is over.  With ``key``, the warm
    prefill's launches, arguments, peak and seconds go to
    ``MEASURED[key]`` for phase 26."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.models import model
    dev = params["embed"]["w"].device
    # int32 tokens, as the serving engine and models/inputs.py give them
    batch = {"inputs": torch.tensor([prompt], dtype=torch.int32, device=dev),
             **(extra or {})}
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base, held = torch.cuda.memory_allocated(), tree_nbytes(
            {"p": params, "b": batch})
        before = (fkernel.launches, lkernel.launches,
                  lkernel.backward_launches)
        t = time.perf_counter()
        model.prefill(params, batch, cfg=cfg, max_len=max_len)
        torch.cuda.synchronize()
        if key:
            launches = (fkernel.launches - before[0],
                        lkernel.launches - before[1],
                        lkernel.backward_launches - before[2])
            MEASURED[key] = step_held(
                launches, 1, held, torch.cuda.max_memory_allocated()
                - (base - held), [time.perf_counter() - t])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            model.prefill(params, batch, cfg=cfg, max_len=max_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    on_card = kernel_times(torch, prof)
    busy_ms = sum(ms for _, _, ms in on_card)
    if not busy_ms:
        print("lm: profiled prefill: the profiler saw no device time; "
              "breakdown not measured")
        return
    ours = {label: sum(ms for name, _, ms in on_card if tag in name)
            for label, tag in (("flash_attention", "flash_tc_kernel"),
                               ("rg_lru_scan", "lru_ring_kernel"))}
    print(f"lm: profiled prefill of {len(prompt)} tokens: {wall * 1e3:.3f} "
          f"ms on the host clock, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f}); "
          + " ".join(f"{name} {ms:.3f} ms ({ms / busy_ms:.3f})"
                     for name, ms in ours.items())
          + "; largest: "
          + "; ".join(f"{name[:60]} x{n} {ms:.3f} ms ({ms / busy_ms:.3f})"
                      for name, n, ms in on_card[:10]))


# ------------------------------------------------------------ phase 8
def train_pcfg():
    """The training knobs of phase 8: full remat, the fused head."""
    from repro_torch.parallel.sharding import ParallelConfig
    return ParallelConfig(mesh=None, remat="full", fused_head=True,
                          head_chunk=HEAD_CHUNK)


def train_data(torch, tmp: Path, cfg, seed: int, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, n_tokens=None, device="cuda"):
    """A Sector cloud holding a synthetic corpus from ``seed`` (default:
    exactly one batch of ``batch`` x (``seq`` + 1) tokens, so every epoch
    is that batch); returns (client, dataset, pipeline)."""
    from repro_torch.data import (DataPipeline, SectorTokenDataset,
                                  write_synthetic_corpus)
    master, client = cloud(tmp)
    write_synthetic_corpus(client, "corpus/train.u32",
                           n_tokens or batch * (seq + 1), cfg.vocab_size,
                           seed=seed)
    ds = SectorTokenDataset(master, client, "corpus/train.u32", seq_len=seq)
    return client, ds, DataPipeline(ds, batch=batch, pcfg=train_pcfg(),
                                    device=device)


def scan_backward_phase(torch, captured):
    """(b): the scan's gradient through the kernel (the time-reversed
    recurrence) against autograd through the plain loop, on the captured
    first RG-LRU layer's ``a, b, h0`` with upstream gradients from a fixed
    seed; both timed."""
    from repro_torch.kernels.rg_lru_scan import ops, ref
    a, b, h0 = captured["scan"]
    gen = torch.Generator().manual_seed(19)
    up = torch.randn(a.shape, generator=gen).to(a.device)
    up_last = torch.randn(h0.shape, generator=gen).to(a.device)
    graphs = {}
    for name, fn in (("kernel", ops.rg_lru_scan), ("plain", ref.lru_scan_ref)):
        ins = [t.clone().requires_grad_() for t in (a, b, h0)]
        h, h_last = fn(*ins)
        graphs[name] = (h, h_last, ins)
    got, want = (torch.autograd.grad(graphs[n][:2], graphs[n][2],
                                     (up, up_last), retain_graph=True)
                 for n in ("kernel", "plain"))
    scale = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(worst <= SCAN_GRAD_TOL * scale,
          f"rg_lru_scan backward differs from autograd through the plain "
          f"loop by {worst} (scale {scale})")
    h = graphs["kernel"][0].detach()
    ms = timed_ms(torch, lambda: ops.rg_lru_scan_backward(a, h, h0, up,
                                                          up_last))
    h_p, hl_p, ins_p = graphs["plain"]
    plain = timed_ms(torch, lambda: torch.autograd.grad(
        (h_p, hl_p), ins_p, (up, up_last), retain_graph=True),
        warmup=1, runs=3)
    # reads a, h, g and h0, g_last; writes da, db and dh0
    n_bytes = 5 * a.nbytes + 3 * h0.nbytes
    bnd, by = bound_ms(n_bytes, 3 * a.numel())
    print(f"kernel rg_lru_scan backward {list(a.shape)}: time-reversed "
          f"kernel + elementwise ms={ms:.4f} bound_ms={bnd:.6f} ({n_bytes} "
          f"bytes; {ms / bnd:.2f}x the bound) plain autograd ms={plain:.4f} "
          f"max_abs_err={worst:.3e} (gradient scale {scale:.3e}, tolerance "
          f"{SCAN_GRAD_TOL} of it)")
    return row("rg_lru_scan_backward", worst, ms, plain, bnd, by)


@contextlib.contextmanager
def moe_routing(torch, routes: list, flips=None):
    """Each ``moe._route`` call's expert ids and positions appended to
    ``routes``; or, with ``flips`` (a list), replayed in call order: the
    gates from this route's own router probabilities at the recorded
    experts (renormalised), the recorded positions, and the aux loss of
    the recorded top-1 choices, while ``flips`` gets the tokens whose
    top-k this route would have changed."""
    import torch.nn.functional as F

    from repro_torch.models import moe
    real = moe._route
    pending = iter(routes)

    def record(p, xg, cfg_):
        out = real(p, xg, cfg_)
        routes.append((out[1].clone(), out[2].clone()))
        return out

    def pinned(p, xg, cfg_):
        eids_k, pos_k = next(pending)
        probs = torch.softmax(xg.float() @ p["router"], dim=-1)
        own = probs.topk(cfg_.top_k, dim=-1).indices
        flips.append(int((own.sort(-1).values != eids_k.sort(-1).values)
                         .any(-1).sum()))
        gates = probs.gather(-1, eids_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        top1 = F.one_hot(eids_k[..., 0], cfg_.n_experts).float()
        aux = cfg_.n_experts * torch.sum(
            top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))) \
            * cfg_.router_aux_coef
        return gates, eids_k, pos_k, aux

    with patched(moe, "_route", record if flips is None else pinned):
        yield


def grad_check(torch, cfg, seed: int, batch, device="cuda",
               label="train", reference=None):
    """(a): one step's loss and gradients by the kernel route against the
    same step by the ``reference`` route (by default ``plain_kernels()``;
    :func:`tile_p_attention` holds the bf16 flash kernel to a plain
    version that rounds as it does), on the same batch and
    parameters.  An MoE's plain route takes the kernel route's routing
    (``moe_routing``): its top-k choices and drops are discrete, and the
    bf16 kernel's rounding moves tokens across near ties (11 (b) pins
    them so too); the plain route left to route itself is printed
    beside.  Returns the parameters and the kernel route's loss and
    gradient tree."""
    from repro_torch.models import model
    from repro_torch.train import step
    from repro_torch.utils.pytree import tree_flatten_with_paths
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               device)
    moe_cfg = cfg.family == "moe"
    reference = reference or plain_kernels
    routes, flips = [], []
    out = {}
    for route in ("kernel", "plain") + (("unpinned",) if moe_cfg else ()):
        t = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if route != "kernel":
                stack.enter_context(reference() if route == "plain"
                                    else plain_kernels())
            if moe_cfg and route != "unpinned":
                stack.enter_context(moe_routing(
                    torch, routes, flips if route == "plain" else None))
            (loss, _), grads = step._value_and_grad_accum(
                params, batch, cfg=cfg, pcfg=train_pcfg())
        out[route] = (float(loss), grads)
        name = reference.__name__ if route == "plain" else route
        print(f"{label}: gradient check, {name} route: loss "
              f"{out[route][0]:.6f} in {time.perf_counter() - t:.2f}s")
    worst_rel, worst_cos, worst_leaf = 0.0, 1.0, ""
    flat = tree_flatten_with_paths(out["kernel"][1])
    for (path, g), (_, w) in zip(flat,
                                 tree_flatten_with_paths(out["plain"][1])):
        g, w = g.double(), w.double()
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        cos = float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))
        if rel > worst_rel:
            worst_rel, worst_leaf = rel, path
        worst_cos = min(worst_cos, cos)
        check(rel <= GRAD_REL_TOL and cos >= GRAD_COS_MIN,
              f"gradient of {path}: kernel route against "
              f"{reference.__name__} route relative error {rel}, cosine "
              f"{cos}")
    d_loss = abs(out["kernel"][0] - out["plain"][0])
    if moe_cfg:
        free = max(_rel(torch, g, w) for (_, g), (_, w) in zip(
            flat, tree_flatten_with_paths(out.pop("unpinned")[1])))
        print(f"{label}: the plain route took the kernel route's routing "
              f"in {len(routes)} MoE calls (forward and recompute); "
              f"tokens whose top-{cfg.top_k} it would change: "
              f"{flips} of {batch['inputs'].numel()}; routing itself, its "
              f"gradients differ from the kernel route's by {free:.3e} "
              f"relative L2 at most")
    print(f"{label}: gradient check against {reference.__name__} over "
          f"{len(flat)} leaves (batch "
          f"{list(batch['inputs'].shape)}): loss diff {d_loss:.3e} "
          f"(tolerance {TRAIN_LOSS_TOL}); worst relative error "
          f"{worst_rel:.3e} ({worst_leaf}; tolerance {GRAD_REL_TOL}), "
          f"worst cosine {worst_cos:.6f} (at least {GRAD_COS_MIN})")
    check(d_loss <= TRAIN_LOSS_TOL, f"loss by the kernel route "
          f"{out['kernel'][0]} against the {reference.__name__} route "
          f"{out['plain'][0]}")
    return params, out["kernel"][0], out["kernel"][1]


def train_path(torch, cfg, seed: int, tmp: Path, seq=TRAIN_SEQ,
               device="cuda", steps=TRAIN_STEPS, key=None):
    """The port's ``Trainer`` on one batch repeated (a one-batch corpus in
    Sector): ``steps`` AdamW steps at the JAX package's default
    learning rate and warm-up.  Returns (trainer, history, (flash, scan,
    scan backward) launches, peak device memory); with ``key``, notes in
    ``MEASURED[key]`` what phase 26 holds the dry run to."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
    client, _, pipe = train_data(torch, tmp, cfg, seed, seq=seq,
                                 device=device)
    t = time.perf_counter()
    # the checkpointer restores nothing here and never saves: zlib over
    # the 43 GB of full-width state would take minutes (check (d) makes
    # the round trip at the reduced config)
    trainer = Trainer(cfg, train_pcfg(),
                      TrainerConfig(steps=steps, ckpt_every=2 ** 62,
                                    log_every=1, seed=seed),
                      pipe, SectorCheckpointer(client, "train"),
                      device=device)
    on_card = device == "cuda"
    base, state = 0, tree_nbytes(trainer._tree())
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    print(f"train: Trainer built (parameters from --seed and the AdamW "
          f"state on {device}) in {time.perf_counter() - t:.2f}s")
    step, seen = trainer._step, None
    if key:
        trainer._step, seen = noting_batch(step)
    fkernel.launches = lkernel.launches = lkernel.backward_launches = 0
    hist = trainer.run(steps)
    trainer._step = step
    launches = (fkernel.launches, lkernel.launches,
                lkernel.backward_launches)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if key:
        MEASURED[key] = step_held(
            launches, steps, state + seen["batch"], peak - (base - state),
            np.diff([0.0] + [h["wall_s"] for h in hist]))
    return trainer, hist, launches, peak


def report_train(cfg, hist, launches, peak, seq=TRAIN_SEQ,
                 label="train") -> float:
    """Print each step's loss, grad norm, seconds and tokens/s; returns
    the median step's seconds."""
    tokens = TRAIN_BATCH * seq
    prev, secs = 0.0, []
    for rec in hist:
        secs.append(rec["wall_s"] - prev)
        prev = rec["wall_s"]
        print(f"{label}: step {rec['step']}: loss={rec['loss']:.6f} "
              f"nll={rec['nll']:.6f} grad_norm={rec['grad_norm']:.4f} "
              f"lr={rec['lr']:.3e} step_s={secs[-1]:.4f} "
              f"tokens_per_s={tokens / secs[-1]:.1f}")
    print(f"{label}: {cfg.name}, batch {TRAIN_BATCH} x "
          f"{seq}, remat full, fused head (chunk {HEAD_CHUNK}): "
          f"median step {statistics.median(secs):.4f}s "
          f"({tokens / statistics.median(secs):.1f} tokens/s), steps after "
          f"the first {[round(s, 4) for s in secs[1:]]}; "
          f"max_memory_allocated={peak}; launches a run of {len(hist)} "
          f"steps: flash_attention={launches[0]} rg_lru_scan={launches[1]} "
          f"rg_lru_scan backward={launches[2]}")
    return statistics.median(secs)


def check_train(cfg, hist, launches) -> None:
    """(c) the loss falls on the repeated batch, finite; (e) the exact
    launches: under full remat each attention launch of a forward
    (``flash_per_prefill``: an encoder-decoder's encoder, decoder and
    cross blocks each) runs twice a step (forward, recompute) and each R
    layer's scan twice forward and once backward."""
    losses = [rec["loss"] for rec in hist]
    check(all(math.isfinite(x) for x in losses)
          and all(math.isfinite(rec["grad_norm"]) for rec in hist),
          f"training losses or grad norms not finite: {losses}")
    check(losses[-1] < losses[0],
          f"the loss did not fall on the repeated batch: {losses}")
    n_attn = flash_per_prefill(cfg)
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    want = (2 * n_attn * len(hist), 2 * n_rec * len(hist),
            n_rec * len(hist))
    check(launches == want,
          f"training launches (flash_attention, rg_lru_scan, rg_lru_scan "
          f"backward) {launches}, expected {want}")


def profile_train_step(torch, trainer, step_s: float) -> None:
    """One more training step under ``torch.profiler``: device busy time,
    idle share against the median unprofiled step, device time by kernel.
    A measurement only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if not busy_ms:
        print("train: profiled step: the profiler saw no device time; "
              "breakdown not measured")
        return
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]
    # device time by class of kernel, read from the kernels' names: the
    # first class whose tags a name holds takes it
    classes = (("flash_attention", ("flash_tc_kernel",)),
               ("rg_lru_scan", ("lru_ring_kernel", "lru_direct_kernel")),
               ("bf16 products (cuBLAS)", ("nvjet",)),
               ("float32 products", ("sgemm", "gemm_f32")),
               ("elementwise", ("elementwise_kernel",)),
               ("reductions", ("reduce_kernel",)),
               ("other", ("",)))
    by_class = dict.fromkeys((name for name, _ in classes), 0.0)
    for e in on_card:
        name = next(n for n, tags in classes if any(t in e.key for t in tags))
        by_class[name] += e.self_device_time_total / 1e3
    print(f"train: profiled step: {wall * 1e3:.3f} ms on the host clock, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f}; against the median step "
          f"{1 - busy_ms / (step_s * 1e3):.3f}); by class: "
          + "; ".join(f"{name} {ms:.3f} ms ({ms / busy_ms:.4f})"
                      for name, ms in by_class.items())
          + "; largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.self_device_time_total / 1e3 / busy_ms:.3f})"
                      for e in top))
    # the same device time by the host-side op that launched it
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    print("train: profiled step: device time by launching op: "
          + "; ".join(f"{e.key} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.self_device_time_total / 1e3 / busy_ms:.3f})"
                      for e in ops))


def time_adamw(torch, trainer) -> None:
    """The AdamW update alone on the full model's state, with CUDA events,
    from the gradients of one more forward and backward.  A measurement
    only: it takes one more optimizer step."""
    from repro_torch.train import optim, step
    from repro_torch.utils.pytree import tree_leaves
    _, grads = step._value_and_grad_accum(
        trainer.params, next(iter(trainer.pipeline)), cfg=trainer.cfg,
        pcfg=trainer.pcfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    optim.apply_updates(trainer.params, grads, trainer.opt, trainer.ocfg,
                        trainer.lr_fn)
    stop.record()
    stop.synchronize()
    n = sum(p.numel() for p in tree_leaves(trainer.params))
    print(f"train: AdamW update of {n} parameters: "
          f"{start.elapsed_time(stop):.3f} ms on the device, "
          f"{(time.perf_counter() - t) * 1e3:.3f} ms on the host clock")


def time_flash_backward(torch, cfg) -> None:
    """The flash Function's backward at phase 8's training shape, q / k /
    v from a fixed seed, once per attention layer a step
    (``flash_backward_times``)."""
    gen = torch.Generator().manual_seed(23)
    B, T = TRAIN_BATCH, TRAIN_SEQ
    q = torch.randn((B, T, cfg.n_heads, cfg.d_head), generator=gen)
    k, v = (torch.randn((B, T, cfg.n_kv_heads, cfg.d_head), generator=gen)
            for _ in range(2))
    qkv = tuple(x.to(torch.bfloat16).cuda() for x in (q, k, v))
    flash_backward_times(torch, "train", {"attn": (qkv, {
        "causal": True, "window": cfg.local_window})},
        {"attn": flash_per_prefill(cfg)})


def resume_check(torch, cfg, seed: int, tmp: Path, device="cuda") -> None:
    """(d): a Sector checkpoint round trip at ``cfg.reduced()`` on the
    card: a run saves at step 2, a new ``Trainer`` restores it (the tree
    bit-identical) and takes step 3, whose loss must equal step 3 of an
    uninterrupted run."""
    from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
    from repro_torch.utils.pytree import tree_leaves
    small = cfg.reduced()
    tcfg = TrainerConfig(steps=3, ckpt_every=2, log_every=1, lr=1e-3,
                         warmup=1, seed=seed)

    def trainer(sub, ckpt: bool):
        client, _, pipe = train_data(torch, tmp / sub, small, seed, seq=128,
                                     n_tokens=20_000, device=device)
        return Trainer(small, train_pcfg(), tcfg, pipe,
                       SectorCheckpointer(client, "r") if ckpt else None,
                       device=device), client

    whole, _ = trainer("whole", False)
    want = whole.run(3)[-1]["loss"]
    first, client = trainer("resume", True)
    first.run(2)
    again = Trainer(small, train_pcfg(), tcfg,
                    train_data(torch, tmp / "again", small, seed, seq=128,
                               n_tokens=20_000, device=device)[2],
                    SectorCheckpointer(client, "r"), device=device)
    check(again.step_idx == 2, f"restored step {again.step_idx}, not 2")
    check(again.pipeline.state_dict() == first.pipeline.state_dict(),
          "the restored data cursor differs")
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves({"p": first.params, "o": first.opt}),
        tree_leaves({"p": again.params, "o": again.opt})))
    check(same, "the restored tree is not bit-identical to the saved one")
    got = again.run(1)[-1]["loss"]
    print(f"train: checkpoint round trip ({small.name}, step 2 through "
          f"Sector): tree bit-identical; step-3 loss {got:.6f} against "
          f"{want:.6f} uninterrupted (diff {abs(got - want):.3e}, "
          f"tolerance {RESUME_LOSS_TOL})")
    check(abs(got - want) <= RESUME_LOSS_TOL,
          f"resumed step-3 loss {got} against {want}")

# ------------------------------------------------------------ phase 9
# report fields that do not depend on how a round was lowered
SIM_FIELDS = ("sim_seconds", "bytes_moved", "bytes_local", "tasks",
              "speculated", "speculation_wins", "retried",
              "locality_fraction", "stage_seconds", "planned_tasks",
              "reused_tasks", "shuffle_rounds", "partitioned_records",
              "udf_traces")
MESH_WORLDS = (3, 4)            # 6 workers: the mesh round; the gathered route
MESH_RECORDS = 2_000_000        # (b): each rank's TeraSort cloud, in
MESH_CHUNK_RECORDS = 160_000    # 13 chunks of 16,000,000 bytes, so every rank
                                # owns some of stage 0 at 3 and 4 ranks
MESH_KEYS = 1_000_000           # (b): uint32 keys a rank for the sorts
MESH_KM_CHUNKS = 12             # (b): kmeans_sphere on the mesh over 12 chunks
MESH_KM_ITERS = 3               # of ASSIGN_ROWS points, 3 iterations
# (b): kmeans_step(mesh=) against the meshless step, the tolerance of the
# CPU test of the meshless step (tests/test_torch_kmeans.py)
STEP_RTOL = STEP_ATOL = 1e-5


def sim_fields(rep) -> dict:
    return {f: getattr(rep, f) for f in SIM_FIELDS}


def stage0_stack(torch, data):
    """Phase 3's stage-0 stack of ``data`` on the card: a slot a 64 MB
    chunk, padded to ``MAIN_ROWS`` rows."""
    from repro_torch.core.records import StackedBatch
    s = -(-len(data) // CHUNK_RECORDS)
    stack = torch.zeros((s, MAIN_ROWS, RECORD), dtype=torch.uint8,
                        device="cuda")
    n_valid = np.zeros(s, np.int32)
    for i in range(s):
        piece = data[i * CHUNK_RECORDS:(i + 1) * CHUNK_RECORDS]
        stack[i, :len(piece)] = torch.tensor(piece, device="cuda")
        n_valid[i] = len(piece)
    return StackedBatch(stack, n_valid)


def time_rounds(torch, mesh, data, bounds) -> None:
    """The rows kernel against its plain version on the mesh round's input
    (the stage-0 stack of the same records, padding rows included), then
    one ``fused_scatter_round`` on the world-1 mesh beside phase 3's
    single-device round (``scatter_round_dispatch`` and its harvest, whose
    histogram copy to the host it includes), CUDA events, median of 20
    after 3 warm-ups.  After the checked run: these launches count for no
    path."""
    from repro_torch.core import spmd
    from repro_torch.core.records import RecordBatch
    from repro_torch.core.shuffle import (_bounds_tensor, range_partitioner,
                                          scatter_round_dispatch)
    from repro_torch.kernels.bucket_partition import kernel, ref
    stacked = stage0_stack(torch, data)
    part = range_partitioner(bounds)
    key_spec, words = part.scatter_spec(RecordBatch.empty(RECORD, "cuda"),
                                        N_BUCKETS)
    flat = stacked.data.reshape(-1, RECORD)
    bwords = _bounds_tensor(words, flat.device)
    got = kernel.bucket_partition_rows(flat, key_spec, bwords,
                                       n_buckets=N_BUCKETS)
    want = ref.bucket_partition_rows_ref(flat, key_spec, bwords, N_BUCKETS)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "bucket_partition_rows differs from its plain version on the mesh "
          "round's input")
    rows_ms = timed_ms(torch, lambda: kernel.bucket_partition_rows(
        flat, key_spec, bwords, n_buckets=N_BUCKETS))
    print(f"mesh: bucket_partition_rows on the round's input "
          f"{list(flat.shape)}: exact against its plain version, "
          f"{rows_ms:.4f} ms")
    workers = [f"s{i}" for i in range(N_BUCKETS)]
    slot_workers = np.sort(np.arange(stacked.n_slots) % N_BUCKETS)

    def mesh_round():
        return spmd.fused_scatter_round(
            stacked.data, stacked.n_valid, words, key_spec=key_spec,
            n_buckets=N_BUCKETS, n_workers=N_BUCKETS, mesh=mesh)

    def single_round():
        return scatter_round_dispatch(
            stacked, part, N_BUCKETS, worker_names=workers,
            slot_workers=slot_workers).harvest()

    mesh_ms = timed_ms(torch, mesh_round)
    single_ms = timed_ms(torch, single_round)
    print(f"mesh: one round on the stage-0 stack {list(stacked.data.shape)}: "
          f"fused_scatter_round (world 1, nccl) {mesh_ms:.4f} ms; phase 3's "
          f"single-device round (scatter_round_dispatch + harvest) "
          f"{single_ms:.4f} ms; regroup buffer "
          f"{N_BUCKETS * stacked.n_slots * MAIN_ROWS * RECORD} bytes "
          f"([{N_BUCKETS}, {stacked.n_slots * MAIN_ROWS}, {RECORD}])")


def mesh_world1(torch, n_records: int, seed: int, tera: dict):
    """(a): phase 3's TeraSort again on a one-rank mesh (NCCL on the
    card).  Returns the path's launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_flat_mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t = time.perf_counter()
    # device_id makes NCCL set up its communicator here (timed and
    # printed), not inside the run's first collective
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    print(f"mesh: nccl group of one rank set up in "
          f"{time.perf_counter() - t:.3f} s")
    try:
        t = time.perf_counter()
        mesh = make_flat_mesh()
        print(f"mesh: make_flat_mesh (with its gloo host group) "
              f"{time.perf_counter() - t:.3f} s")
        launches, rep, outs, data, order, bounds, wall_s, paths = \
            terasort_path(torch, n_records, seed, mesh=mesh,
                          label="mesh terasort (world 1, nccl)")
        check_terasort(launches["bucket_partition_rows"], rep, outs, data,
                       order)
        check(launches["bucket_dest"] == 0,
              f"the mesh path launched bucket_dest {launches['bucket_dest']} "
              f"times")
        check(paths == ["mesh"], f"the mesh run's shuffle took {paths}")
        check(sim_fields(rep) == tera["report"],
              f"the mesh run's report {sim_fields(rep)} differs from phase "
              f"3's {tera['report']}")
        print(f"mesh: world-1 TeraSort {wall_s:.3f} s, "
              f"{n_records / wall_s:.0f} records/s, shuffle round "
              f"{rep.partition_seconds:.4f} s; phase 3 {tera['wall_s']:.3f} s, "
              f"{n_records / tera['wall_s']:.0f} records/s, shuffle round "
              f"{tera['round_s']:.4f} s (host clock, this call)")
        del outs, order, rep
        time_rounds(torch, mesh, data, bounds)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def own_chunks(plan, workers, rank: int, world: int) -> list:
    """(b): the stage-0 chunks rank ``rank`` of ``world`` owns: the plan's
    ``(key, executor, nbytes)`` tasks with bytes, stable-sorted by their
    executor's place in ``workers``, in blocks of ``ceil(n / world)``."""
    order = sorted((t for t in plan if t[2] > 0),
                   key=lambda t: workers.index(t[1]))
    k = -(-len(order) // world)
    return [t[0] for t in order[rank * k:(rank + 1) * k]]


def stage0_reads(tracer, stage: str, workers, rank: int, world: int
                 ) -> dict:
    """(b): what a run read at stage ``stage``, from its tracer: the chunks
    fetched (a ``fetch-chunk`` span a read attempt), their seconds (the
    fetch, decode and copy to the card, on the host clock), the stage's
    own seconds (``exec:<stage>``), its plan's chunks and those this rank
    owns."""
    ev = tracer.snapshot()
    plan = list({e.name: (e.name[len("task:"):], e.track[len("worker:"):],
                          e.attrs["nbytes"]) for e in ev
                 if e.clock == "sim" and e.name.startswith("task:")
                 and e.attrs.get("stage") == stage}.values())
    fetches = [e for e in ev if e.name == "fetch-chunk"]
    return {"fetched": [e.attrs["key"] for e in fetches],
            "fetch_s": sum(e.wall_seconds for e in fetches),
            "stage0_s": sum(e.wall_seconds for e in ev
                            if e.name == f"exec:{stage}"),
            "plan": [k for k, _, n in plan if n],
            "own": own_chunks(plan, workers, rank, world)}


def mesh_terasort(torch, mesh, seed: int, n_records: int) -> dict:
    """(b): TeraSort of the rank's own cloud on ``mesh``: its launches,
    report, outputs' check, what stage 0 read and the card's peak memory
    after stage 0 (``max_memory_allocated`` as the shuffle starts).
    Checks nothing of the split: also run on an older tree's engine."""
    from repro_torch.core.executor import ArrayExecutor
    from repro_torch.core.trace import Tracer
    tracer, peak0 = Tracer(), []
    bucketize = ArrayExecutor.bucketize

    def noting(self, *a, **kw):
        if not peak0:
            peak0.append(torch.cuda.max_memory_allocated())
        return bucketize(self, *a, **kw)

    with patched(ArrayExecutor, "bucketize", noting):
        launches, rep, outs, data, order, _, wall_s, paths = terasort_path(
            torch, n_records, seed, mesh=mesh, verbose=False,
            chunk_records=MESH_CHUNK_RECORDS, tracer=tracer)
    same = b"".join(outs) == data[order].tobytes()
    del outs, data, order
    workers = sorted(f"s{i}" for i in range(N_BUCKETS))
    return {"launches": launches, "rep": rep, "wall_s": wall_s,
            "paths": paths, "same": same, "peak0": peak0[0],
            "peak": torch.cuda.max_memory_allocated(),
            **stage0_reads(tracer, "partition", workers,
                           mesh.axis_index("data"), mesh.shape["data"])}


def mesh_kmeans(torch, mesh, seed: int, n_points: int) -> dict:
    """(b): ``kmeans_sphere`` over the rank's own cloud of ``n_points``
    points (replication 2, chunks of ``ASSIGN_ROWS`` points: 64 MiB), on
    the meshless engine and then on ``mesh`` in this rank: each run's
    centroids, report, ``kmeans_partials`` (and ids kernel) launches, wall
    and reads."""
    from repro_torch.core import SphereEngine
    from repro_torch.core.kmeans import encode_points, kmeans_sphere
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels.kmeans_assign import kernel
    pts = make_points(torch, n_points, seed, mesh.device)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_km_"))
    out = {}
    try:
        master, client = cloud(tmp, ASSIGN_ROWS * DIM * 4)
        client.upload("angle/points.f32", encode_points(pts), replication=2)
        del pts
        out["chunks"] = master.files["angle/points.f32"].n_chunks
        for key, m in (("meshless", None), ("mesh", mesh)):
            tracer = Tracer()
            engine = SphereEngine(master, client, tracer=tracer, mesh=m,
                                  device=mesh.device if m is None else None)
            torch.cuda.synchronize()
            kernel.partials_launches = kernel.launches = 0
            t = time.perf_counter()
            cents, rep = kmeans_sphere(engine, "angle/points.f32", dim=DIM,
                                       k=K, iters=MESH_KM_ITERS, seed=seed,
                                       backend="array")
            torch.cuda.synchronize()
            out[key] = {
                "cents": cents, "fields": sim_fields(rep),
                "launches": (kernel.partials_launches, kernel.launches),
                "wall_s": time.perf_counter() - t,
                **stage0_reads(tracer, "assign", engine._workers(),
                               *((0, 1) if m is None else
                                 (m.axis_index("data"), m.shape["data"])))}
            del engine
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def stage0_rank(rank: int, world: int, seed: int, n_records: int,
                n_points: int) -> dict:
    """(b)'s TeraSort and k-means on ``world`` ranks sharing the card,
    measured and not checked (``scripts/mesh_stage0.py`` runs it on this
    tree's engine and on an older one's)."""
    import torch

    from repro_torch.launch.mesh import make_flat_mesh
    mesh = make_flat_mesh()
    torch.cuda.reset_peak_memory_stats()
    tera = mesh_terasort(torch, mesh, seed, n_records)
    tera.pop("rep")
    km = mesh_kmeans(torch, mesh, seed, n_points)
    for run in ("meshless", "mesh"):
        km[run].pop("cents")
    return {"terasort": tera, "kmeans": km}


def mesh_rank(rank: int, world: int, seed: int, n_records: int,
              n_keys: int, n_points: int) -> dict:
    """(b): one of ``world`` ranks sharing the card over gloo (started by
    ``launch.mesh.run_ranks``).  TeraSort of its own cloud (the mesh round
    when ``world`` divides the 6 workers, else the gathered route), its
    stage 0 reading exactly the rank's own slots' chunks; the two sorts;
    ``kmeans_step(mesh=)``; ``kmeans_sphere`` on the mesh bit for bit the
    meshless run's, assigning only the rank's own chunks.  Every check
    here, nothing caught.  Returns what rank 0 prints and the parent
    checks across the ranks."""
    import torch

    from repro_torch.core import spmd
    from repro_torch.core.kmeans import kmeans_step
    from repro_torch.launch.mesh import make_flat_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = make_flat_mesh()
    check(mesh.host_staged,
          f"rank {rank} is on {mesh.device} over {mesh.backend}")
    out = {"device": str(mesh.device),
           "transport": "gloo (host-staged)" if mesh.host_staged
           else mesh.backend}
    route = "mesh" if N_BUCKETS % world == 0 else "mesh-gathered"
    kernel_on, other = (("bucket_partition_rows", "bucket_dest")
                        if route == "mesh" else
                        ("bucket_dest", "bucket_partition_rows"))
    torch.cuda.reset_peak_memory_stats()
    tera = mesh_terasort(torch, mesh, seed, n_records)
    rep, launches = tera.pop("rep"), tera["launches"]
    check(tera["paths"] == [route],
          f"rank {rank}/{world}: shuffle took {tera['paths']}")
    check(launches[kernel_on] == rep.shuffle_rounds
          and launches[other] == 0,
          f"rank {rank}/{world}: launches {launches} for "
          f"{rep.shuffle_rounds} rounds on the {route} route")
    check(rep.host_syncs == rep.shuffle_rounds,
          f"rank {rank}/{world}: host_syncs {rep.host_syncs}")
    check(tera["same"],
          f"rank {rank}/{world}: sorted output differs from the oracle")
    check(len(tera["plan"]) >= 12,
          f"rank {rank}/{world}: stage 0 has {len(tera['plan'])} chunks")
    check(sorted(tera["fetched"]) == sorted(tera["own"]) and tera["own"],
          f"rank {rank}/{world}: stage 0 fetched {tera['fetched']}, its "
          f"own slots' chunks are {tera['own']}")
    out["terasort"] = {**tera, "route": route,
                       "round_s": rep.partition_seconds}
    # the sorts: this rank's block of world x n_keys keys from the seed
    keys = np.random.default_rng([seed, 9]).integers(
        0, 2 ** 32, world * n_keys, dtype=np.uint32)
    mine = torch.from_numpy(keys[rank * n_keys:(rank + 1) * n_keys]
                            .view(np.int32)).to(mesh.device) \
        .view(torch.uint32)
    t = time.perf_counter()
    srt, valid = spmd.distributed_sort(mine, mesh)
    bar = spmd.barrier_sort(mine, mesh)
    valid = valid.cpu()                  # waits for the device
    out["sorts_s"] = time.perf_counter() - t
    every = spmd.gather_blocks(srt, mesh).view(torch.int32).cpu().numpy() \
        .view(np.uint32).reshape(world, -1)
    counts = spmd.gather_blocks(valid, mesh).cpu().numpy()
    want = np.sort(keys)
    got = np.concatenate([every[r, :counts[r]] for r in range(world)])
    check(np.array_equal(got, want),
          f"rank {rank}/{world}: distributed_sort differs from np.sort")
    got = spmd.gather_blocks(bar, mesh).view(torch.int32).cpu().numpy() \
        .view(np.uint32)
    check(np.array_equal(got, want),
          f"rank {rank}/{world}: barrier_sort differs from np.sort")
    # kmeans_step on the rank's slice of the points (slices may differ by
    # one point: the step takes any block)
    pts = torch.from_numpy(make_points(torch, n_points, seed,
                                       mesh.device)).to(mesh.device)
    cents = torch.from_numpy(np.random.default_rng([seed, 3]).normal(
        size=(K, DIM)).astype(np.float32) * 4).to(mesh.device)
    lo, hi = (n_points * rank // world, n_points * (rank + 1) // world)
    new_c, inertia = kmeans_step(pts[lo:hi], cents, mesh=mesh)
    ref_c, ref_i = kmeans_step(pts, cents)
    err = float((new_c - ref_c).abs().max())
    check(torch.allclose(new_c, ref_c, rtol=STEP_RTOL, atol=STEP_ATOL)
          and math.isclose(float(inertia), float(ref_i), rel_tol=STEP_RTOL),
          f"rank {rank}/{world}: kmeans_step(mesh=) off the meshless step by "
          f"{err} (inertia {float(inertia)} against {float(ref_i)})")
    out["kmeans_err"] = err
    del pts, new_c, ref_c
    torch.cuda.empty_cache()
    # kmeans_sphere on the mesh against the meshless run, same cloud
    km = mesh_kmeans(torch, mesh, seed, MESH_KM_CHUNKS * n_points)
    one, many = km["meshless"], km["mesh"]
    check(km["chunks"] == MESH_KM_CHUNKS,
          f"rank {rank}/{world}: k-means cloud of {km['chunks']} chunks")
    check(np.array_equal(one["cents"], many["cents"]),
          f"rank {rank}/{world}: kmeans_sphere on the mesh differs from the "
          f"meshless run by {np.abs(one['cents'] - many['cents']).max()}")
    check(one["fields"] == many["fields"],
          f"rank {rank}/{world}: k-means report {many['fields']} against "
          f"the meshless {one['fields']}")
    check(one["launches"] == (MESH_KM_CHUNKS * MESH_KM_ITERS, 0),
          f"rank {rank}/{world}: meshless launches {one['launches']}")
    check(many["launches"] == (len(many["own"]) * MESH_KM_ITERS, 0),
          f"rank {rank}/{world}: kmeans_partials launched "
          f"{many['launches']} times for {len(many['own'])} own tasks x "
          f"{MESH_KM_ITERS} iterations")
    check(sorted(many["fetched"]) == sorted(many["own"]),
          f"rank {rank}/{world}: k-means fetched {many['fetched']}, its "
          f"own slots' chunks are {many['own']}")
    for run in (one, many):
        run.pop("cents")
    out["kmeans_sphere"] = km
    return out


def mesh_ranks(seed: int, n_records: int) -> dict:
    """(b): 3 and 4 ranks sharing the card over gloo.  Returns each
    world's launches summed over its ranks."""
    from repro_torch.launch.mesh import run_ranks
    card = card_line()
    launches = {}
    for world in MESH_WORLDS:
        t = time.perf_counter()
        res = run_ranks(mesh_rank, world,
                        (seed, n_records, MESH_KEYS, ASSIGN_ROWS),
                        timeout_s=300, join_timeout_s=600)
        r0 = res[0]
        ts = [r["terasort"] for r in res]
        kms = [r["kmeans_sphere"] for r in res]
        # stage 0 split: disjoint sets covering the plan
        owned = [k for x in ts for k in x["own"]]
        check(sorted(owned) == sorted(ts[0]["plan"]),
              f"{world} ranks: stage-0 chunks owned {owned}, the plan's "
              f"{ts[0]['plan']}")
        k_owned = [k for x in kms for k in x["mesh"]["own"]]
        check(sorted(k_owned) == sorted(kms[0]["mesh"]["plan"]),
              f"{world} ranks: k-means chunks owned {k_owned}")
        k_sum = sum(x["mesh"]["launches"][0] for x in kms)
        check(k_sum == MESH_KM_CHUNKS * MESH_KM_ITERS,
              f"{world} ranks: kmeans_partials launched {k_sum} times in "
              f"all for {MESH_KM_CHUNKS} chunks x {MESH_KM_ITERS} iterations")
        launches[world] = {
            name: sum(x["launches"][name] for x in ts)
            for name in ("bucket_dest", "bucket_partition_rows")}
        launches[world]["kmeans_partials"] = k_sum
        print(f"mesh: {world} ranks on {r0['device']} over "
              f"{r0['transport']}, {n_records} records each: TeraSort "
              f"route {ts[0]['route']}, wall "
              + ", ".join(f"{x['wall_s']:.3f}" for x in ts) + " s, round "
              + ", ".join(f"{x['round_s']:.4f}" for x in ts)
              + f" s, launches {[x['launches'] for x in ts]}; sorts of "
              f"{MESH_KEYS} keys a rank "
              + ", ".join(f"{r['sorts_s']:.3f}" for r in res)
              + f" s; kmeans_step(mesh=) on {ASSIGN_ROWS} points within "
              f"{max(r['kmeans_err'] for r in res):.3e} of the meshless "
              f"step; {time.perf_counter() - t:.1f} s with the spawn")
        print(f"mesh: {world} ranks, stage 0 of {len(ts[0]['plan'])} chunks "
              f"split: chunks fetched a rank "
              f"{[len(x['fetched']) for x in ts]}, fetch spans "
              + ", ".join(f"{x['fetch_s']:.4f}" for x in ts)
              + " s, exec:partition "
              + ", ".join(f"{x['stage0_s']:.4f}" for x in ts)
              + " s, peak after stage 0 "
              f"{[x['peak0'] for x in ts]} B, TeraSort peak "
              f"{[x['peak'] for x in ts]} B, wall "
              + ", ".join(f"{x['wall_s']:.3f}" for x in ts)
              + f" s ({card})")
        print(f"mesh: {world} ranks, kmeans_sphere over {MESH_KM_CHUNKS} x "
              f"{ASSIGN_ROWS} points, {MESH_KM_ITERS} iterations: centroids "
              f"bit for bit the meshless run's on every rank; "
              f"kmeans_partials launches a rank "
              f"{[x['mesh']['launches'][0] for x in kms]} (meshless "
              f"{kms[0]['meshless']['launches'][0]}), chunks fetched "
              f"{[len(x['mesh']['fetched']) for x in kms]}, wall "
              + ", ".join(f"{x['mesh']['wall_s']:.3f}" for x in kms)
              + " s (meshless "
              + ", ".join(f"{x['meshless']['wall_s']:.3f}" for x in kms)
              + f" s) ({card})")
    return launches


# ------------------------------------------------------------ phases 10-11
XLSTM_ARCH, MOE_ARCH = "xlstm-1.3b", "qwen3-moe-30b-a3b"
# (25): the layers of xlstm-1.3b that train on the card, at full width.
# Its sLSTM runs token by token on the host (about 40 launches a token
# and layer): a step of the whole stack of 48 at 2 x 3,072 took 80-114 s
# on an NVIDIA H100 80GB HBM3, so phase 25 trains the first pattern unit,
# 2 steps (its first step takes about 35 s, the next about 17 s), to stay
# in the run's 1,200 s
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_STEPS = 8, 2
# (10): the layers of xlstm-1.3b served, at full width: one pattern unit.
# Serving all 48 took 155-165 s (the two long prefills alone 35-43 s),
# and 16 took 51-72 s of a whole run of 837-1,063 s on the card, too
# close to its 1,200 s limit
XLSTM_SERVE_LAYERS = 8
MLSTM_TOL = 1e-3                # (10b): of the chunkwise output's |max|
DECODE_TOLS = (0.02, 0.05)      # (10c): tests/test_models.py's bounds
CONSISTENCY_LEN = 512           # (10c): the float32 prompt
DISPATCH_TOL = 2e-2             # (11c): einsum vs gather, of the scale


def serve_family(torch, cfg, params, prompts, frames=None):
    """Phase 7's harness on another family (with an encoder-decoder's
    ``frames``): serve, check (tokens, slots, the launches a prefill and
    a step make), report.  Returns (engine, requests, launches, last
    logits, median steady step seconds)."""
    eng, reqs, steps, launches, last_logits, peak = serve_path(
        torch, cfg, params, prompts, device=params["embed"]["w"].device.type,
        frames=frames)
    check_serve(cfg, eng, reqs, steps, launches)
    steady_s = report_serve(reqs, steps, launches, peak)
    long_s = {len(r.prompt): r.t_first - r.t_admit for r in reqs
              if len(r.prompt) in LONG_PROMPTS}
    print(f"serve: {cfg.name}: prefill seconds "
          + " ".join(f"{n} tokens {sec:.4f}" for n, sec in long_s.items()))
    return eng, reqs, launches, last_logits, steady_s


def mlstm_check(torch, cfg, captured) -> None:
    """(10b): the first mLSTM layer's captured input, in float32: the
    chunkwise form (CHUNK 256) against the sequential oracle."""
    from repro_torch.models import xlstm
    from repro_torch.utils.pytree import tree_map
    (p, x), _ = captured
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(lambda a: a.float(), p)
    x32 = x.float()
    with torch.inference_mode():
        t = time.perf_counter()
        got, _ = xlstm.mlstm_apply(p32, x32, cfg=cfg32)
        sync(torch, x.device)
        t_chunk = time.perf_counter() - t
        t = time.perf_counter()
        want = xlstm.mlstm_sequential_oracle(p32, x32, cfg=cfg32)
        sync(torch, x.device)
        t_seq = time.perf_counter() - t
    scale = float(got.abs().max())
    err = float((got - want).abs().max())
    print(f"xlstm: first mLSTM layer {list(x.shape)} float32: chunkwise "
          f"(L={xlstm.CHUNK}) vs sequential oracle max abs err {err:.4e} "
          f"(scale {scale:.4e}, ratio {err / scale:.3e}, tolerance "
          f"{MLSTM_TOL}); chunkwise {t_chunk:.3f}s, sequential {t_seq:.3f}s")
    check(bool(torch.isfinite(got).all()) and err <= MLSTM_TOL * scale,
          f"chunkwise mLSTM differs from the sequential oracle by {err} "
          f"(scale {scale})")


def decode_consistency(torch, cfg, params, seed: int,
                       S: int = CONSISTENCY_LEN) -> None:
    """(10c): the model's first pattern unit (8 layers: 7 mLSTM, 1 sLSTM)
    in float32 at full width, with the model's embedding and head: a
    prefill of 511 tokens and a decode of the 512th against the full
    forward's last two logit rows.  One unit, not 48 layers:
    at random weights the deep stack is chaotic in float32 (the port's
    forward and prefill part by 0.145 of the scale at 48 layers, d_model
    256, against 7.2e-5 at 8: ``scripts/depth_divergence.py``; the JAX
    package's part as far), so at full depth the check would measure the
    weights, not the decode path."""
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_map
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=cfg.pattern_len)
    p32 = dict(tree_map(lambda a: a.float(), {
        k: v for k, v in params.items() if k != "blocks"}),
        blocks=tree_map(lambda a: a[:1].float(), params["blocks"]))
    dev = params["embed"]["w"].device
    toks = torch.from_numpy(np.random.default_rng([seed, 10]).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        t = time.perf_counter()
        full, _ = model.forward(p32, {"inputs": toks}, cfg=cfg32)
        last, cache = model.prefill(p32, {"inputs": toks[:, :S - 1]},
                                    cfg=cfg32, max_len=S + 4)
        dec, _ = model.decode_step(
            p32, cache, toks[:, S - 1:],
            torch.full((1,), S - 1, dtype=torch.int32, device=dev),
            cfg=cfg32)
        sync(torch, dev)
    sec = time.perf_counter() - t
    for label, got, want, tol in (
            ("prefill", last, full[:, S - 2], DECODE_TOLS[0]),
            ("decode", dec, full[:, S - 1], DECODE_TOLS[1])):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        print(f"xlstm: float32 {label} vs forward row: max abs err "
              f"{err:.4e} (scale {scale:.4e}, ratio {err / scale:.3e}, "
              f"tolerance {tol})")
        check(bool(torch.isfinite(got).all()) and err < tol * scale,
              f"float32 {label} differs from the forward by {err} "
              f"(scale {scale})")
    print(f"xlstm: float32 consistency ({cfg32.n_layers} layers, d_model "
          f"{cfg32.d_model}) at {S} tokens {sec:.2f}s (forward, a prefill "
          f"of {S - 1} in chunks of 1, one decode)")


def fresh_card(torch, phase, what: str = "before it") -> float:
    """Release what earlier phases left cached; print what is still
    allocated.  Returns the phase's start on the host clock."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase {phase}: {torch.cuda.memory_allocated()} bytes allocated "
          f"({torch.cuda.memory_reserved()} reserved) on the card {what}; "
          f"{free} of {total} bytes free")
    return time.perf_counter()


def xlstm_phase(torch, seed: int) -> None:
    """Phase 10: ``xlstm-1.3b`` at full width and ``XLSTM_SERVE_LAYERS``
    of its layers in bf16, served (no kernel launch: ``check_serve`` wants
    0 and 0); the chunkwise mLSTM against the oracle; the float32 decode
    consistency."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    cfg = get_config(XLSTM_ARCH)
    print(f"xlstm: the first {XLSTM_SERVE_LAYERS} of its {cfg.n_layers} "
          f"layers, at full width")
    cfg, params = lm_model(torch, seed,
                           cfg.replace(n_layers=XLSTM_SERVE_LAYERS))
    prompts = serve_prompts(cfg, seed)
    captured = capture_calls(torch, cfg, params, prompts[0],
                             {"mlstm": (xlstm, "mlstm_apply")})
    mlstm_check(torch, cfg, captured["mlstm"])
    del captured
    eng, reqs, _, _, steady_s = serve_family(torch, cfg, params, prompts)
    profile_decode(torch, eng, steady_s)
    profile_prefill(torch, cfg, params, prompts[0])
    del eng, reqs
    torch.cuda.empty_cache()
    decode_consistency(torch, cfg, params, seed)


def dispatch_check(torch, cfg, captured) -> None:
    """(11c): the first MoE layer's captured input through both dispatch
    modes at the default capacity: the same tokens dropped (all slots
    past capacity: a zero output in both), outputs within DISPATCH_TOL
    of the scale; both timed, beside the FLOPs each spends."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ParallelConfig
    (p, x), _ = captured
    modes = {m: ParallelConfig(mesh=None, moe_dispatch=m)
             for m in ("einsum", "gather")}
    with torch.inference_mode():
        outs = {m: moe.apply(p, x, cfg=cfg, pcfg=pc)[0]
                for m, pc in modes.items()}
        B, T, d = x.shape
        xg = x.reshape(1, B * T, d)
        _, _, pos, _ = moe._route(p, xg, cfg)
        C = moe.capacity(B * T, cfg)
        kept = int((pos < C).sum())
        dropped_tokens = int((pos >= C).all(-1).sum())
        ms = {m: timed_ms(torch, lambda pc=pc: moe.apply(p, x, cfg=cfg,
                                                         pcfg=pc))
              for m, pc in modes.items()}
    e, g = outs["einsum"].float(), outs["gather"].float()
    scale = float(g.abs().max())
    err = float((e - g).abs().max())
    zero_e, zero_g = (o.abs().amax(-1) == 0 for o in (e, g))
    E, k, f = cfg.n_experts, cfg.top_k, cfg.moe_d_ff
    transport = 2 * 2 * B * T * E * C * d          # dispatch + combine
    experts = 3 * 2 * E * C * d * f
    print(f"moe: first MoE layer {list(x.shape)} bf16, group {B * T}, "
          f"capacity {C}: {kept} of {B * T * k} slots kept, "
          f"{dropped_tokens} tokens dropped whole; einsum vs gather max abs "
          f"diff {err:.4e} (scale {scale:.4e}, ratio {err / scale:.3e}, "
          f"tolerance {DISPATCH_TOL}); einsum_ms={ms['einsum']:.4f} "
          f"gather_ms={ms['gather']:.4f} (einsum/gather "
          f"{ms['einsum'] / ms['gather']:.3f}); one-hot transport "
          f"{transport / 1e9:.1f} GFLOP beside the experts' "
          f"{experts / 1e9:.1f} GFLOP a layer")
    check(bool(torch.equal(zero_e, zero_g)),
          "einsum and gather dispatch dropped different tokens")
    check(err <= DISPATCH_TOL * scale,
          f"einsum and gather dispatch differ by {err} (scale {scale})")


def path_flash_times(torch, label, captured) -> dict:
    """(11d, 12b, 13c, 16-20): flash_attention at a serving path's shape
    (a captured launch's q / k / v): held to its plain version and the
    tile-rounded-p oracle, and timed beside SDPA and its bound."""
    from repro_torch.kernels.flash_attention.cost import flash_cost
    (q, k, v), kw = captured
    causal, window = kw["causal"], kw["window"]
    err, err_r, excess, row = check_attention(torch, q, k, v, causal,
                                              window)
    ms, plain, lib, lib_err = attention_times(torch, q, k, v, causal, window)
    ops, n_bytes = flash_cost(q.shape, k.shape, q.element_size(), causal,
                              window)
    bnd, by = bound_ms(n_bytes, ops, PEAK_BF16_PER_S)
    print(f"kernel flash_attention {label} q {list(q.shape)} k/v "
          f"{list(k.shape)} {q.dtype} causal={causal}: kernel_ms={ms:.4f} "
          f"bound_ms={bnd:.4f} ({ops} operations; {n_bytes} bytes) "
          f"({ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, {ms / bnd:.2f}x the "
          f"bound) plain_ms={plain:.4f} sdpa_ms={lib:.4f} (max err vs "
          f"plain {lib_err:.3e}; {lib / ms:.3f}x the kernel's speed) "
          f"max_abs_err={err:.3e} bf16_max_abs_err_vs_tile_rounded_p="
          f"{err_r:.3e} (beyond what rounding allows: {excess:.3e}; "
          f"against the row-rounded p: {row:.3e})")
    return {"shape": f"q {list(q.shape)} k/v {list(k.shape)}",
            "causal": causal, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


@contextlib.contextmanager
def rounded_p_attention(torch):
    """The flash launcher swapped for ``attention_rounded_p``: the bf16
    kernel's numerics in plain PyTorch (p rounded to bf16), float32 sums
    in another order."""
    from repro_torch.kernels.flash_attention import kernel as fkernel

    def attn(q, k, v, *, causal, window):
        return attention_rounded_p(torch, q, k, v, causal, window).to(q.dtype)

    with patched(fkernel, "flash_attention_fwd", attn):
        yield


@contextlib.contextmanager
def tile_p_attention():
    """The flash launcher swapped for ``attention_tile_p`` rounded to q's
    type: the bf16 kernel's numerics in plain PyTorch, p rounded tile for
    tile as the kernel rounds it, float32 sums in another order."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fkernel

    def attn(q, k, v, *, causal, window):
        return attention_tile_p(torch, q, k, v, causal, window).to(q.dtype)

    with patched(fkernel, "flash_attention_fwd", attn):
        yield


def check_moe_layers(torch, cfg, params, prompts, last_logits) -> None:
    """(11b): the long prompts through the kernel route against the plain
    route, layer by layer.  One more kernel-route prefill (its logits
    must be the served ones) records every layer's input, output and MoE
    routing; each layer then runs again under ``plain_kernels()`` from
    the recorded input with its routing pinned to the recorded one, and
    its update (output minus input: attention plus MoE FFN) must lie
    within ``LOGIT_TOL`` of the update's largest magnitude.  The last
    logits of whole plain-route prefills are printed beside them: at
    random weights the 48-layer bf16 stack is chaotic (a router's top-8
    jumps across near ties, and the hidden states part further each
    layer), so end to end the routes part by more than the scale."""
    from repro_torch.models import model, transformer
    served = dict(last_logits)
    dev = params["embed"]["w"].device
    real_unit = transformer._unit_apply

    def prefill(prompt):
        with torch.inference_mode():
            logits, _ = model.prefill(
                params, {"inputs": torch.tensor([prompt], device=dev)},
                cfg=cfg, max_len=SERVE_LEN)
        return logits[0].float().cpu()

    for prompt in prompts[:len(LONG_PROMPTS)]:
        routes, layers = [], []

        def record_unit(unit, x, **kw):
            first = len(routes)
            out = real_unit(unit, x, **kw)
            layers.append((unit, x.clone(), out[0].clone(), first, kw))
            return out

        with moe_routing(torch, routes), \
                patched(transformer, "_unit_apply", record_unit):
            got = prefill(prompt)
        check(torch.equal(got, served[len(prompt)]),
              f"prompt {len(prompt)}: a second kernel-route prefill gave "
              f"other logits than the served one")
        check(len(layers) == len(routes) == cfg.n_layers,
              f"{len(layers)} layers and {len(routes)} routings recorded")
        with plain_kernels():
            plain = prefill(prompt)
        with rounded_p_attention(torch):
            rounded = prefill(prompt)
        worst, flips = 0.0, []
        for unit, x, y, first, kw in layers:
            with plain_kernels(), \
                    moe_routing(torch, routes[first:first + 1], flips), \
                    torch.inference_mode():
                want = real_unit(unit, x, **kw)[0]
            upd, upd_want = (y.float() - x.float()), (want.float() - x.float())
            worst = max(worst, float((upd - upd_want).abs().max())
                        / float(upd_want.abs().max()))
        ends = {name: float((got - o).abs().max()) / float(o.abs().max())
                for name, o in (("plain", plain), ("rounded_p", rounded))}
        print(f"serve: {cfg.name}: prompt {len(prompt)}: each of "
              f"{len(layers)} layers from the kernel route's input, its "
              f"update by the plain route with the routing pinned: worst "
              f"max abs diff {worst:.3e} of the update's scale (tolerance "
              f"{LOGIT_TOL}); tokens whose top-{cfg.top_k} the plain route "
              f"would change there: first layer {flips[0]}, worst "
              f"{max(flips)} of {len(prompt)}; end to end, last logits vs "
              f"the plain route {ends['plain']:.3e} and vs the rounded-p "
              f"attention {ends['rounded_p']:.3e} of their scale (argmax "
              f"{int(got.argmax())}, {int(plain.argmax())}, "
              f"{int(rounded.argmax())})")
        check(worst <= LOGIT_TOL,
              f"prompt {len(prompt)}: a layer's update by the kernel route "
              f"differs from the plain route's by {worst} of its scale")


def moe_phase(torch, seed: int):
    """Phase 11: ``qwen3-moe-30b-a3b`` at its full config in bf16,
    served; its logits against a plain-kernel reference; the two
    dispatch modes on the first MoE layer; flash_attention at its shape.
    Returns (serving launches, the flash timings at its shape)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.models import moe
    cfg, params = lm_model(torch, seed, get_config(MOE_ARCH))
    prompts = serve_prompts(cfg, seed)
    captured = capture_calls(torch, cfg, params, prompts[0], {
        "moe": (moe, "apply"), "attn": (fkernel, "flash_attention_fwd")})
    dispatch_check(torch, cfg, captured["moe"])
    with torch.inference_mode():
        flash = path_flash_times(torch, f"{MOE_ARCH} global",
                                 captured["attn"])
    del captured
    torch.cuda.empty_cache()
    eng, reqs, launches, last_logits, steady_s = serve_family(
        torch, cfg, params, prompts)
    check_moe_layers(torch, cfg, params, prompts, last_logits)
    profile_decode(torch, eng, steady_s)
    profile_prefill(torch, cfg, params, prompts[0])
    return launches, flash


# ------------------------------------------------------------ phases 12-13
ENCDEC_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "llava-next-mistral-7b"
PLUMBING_TOL = 1e-4             # (12d): of the forward's last logits' |max|
PATCH_START = 5                 # (13b): the anyres patches' first position


def serve_frames(cfg, seed: int, n: int = N_REQUESTS, rows: int = SERVE_LEN):
    """One float32 ``[1, rows, d_model]`` array of encoder frames a
    request, drawn from ``seed``."""
    rng = np.random.default_rng([seed, 12])
    return [rng.standard_normal((1, rows, cfg.d_model), dtype=np.float32)
            for _ in range(n)]


def split_unit(torch, cfg, unit, x, kw) -> list:
    """The layers of one pattern unit run one at a time by the kernel
    route from the unit's input ``x``: ``[(one-layer unit, its kw, input,
    output)]``, each layer as a unit of a one-symbol pattern (the same
    ops as inside the unit)."""
    from repro_torch.models import transformer
    out = []
    with torch.inference_mode():
        for i, sym in enumerate(cfg.block_pattern):
            one = {"layer0": unit[f"layer{i}"]}
            kw1 = dict(kw, cfg=cfg.replace(block_pattern=(sym,),
                                           n_layers=cfg.n_groups))
            y = transformer._unit_apply(one, x, **kw1)[0]
            out.append((one, kw1, x, y))
            x = y
    return out


def layer_update(torch, unit, x, kw):
    """(output, update) of one unit run from ``x`` by whatever route is
    in force: the update is the float32 sum of what its blocks add to the
    residual stream (self- and cross-attention, FFN or MoE outputs),
    taken before each is rounded into the bf16 stream."""
    from repro_torch.models import attention, mlp, moe, transformer
    parts = []

    def spy(module, pair):
        real = module.apply

        def call(*args, **kw_):
            out = real(*args, **kw_)
            parts.append((out[0] if pair else out).float())
            return out
        return patched(module, "apply", call)

    with spy(attention, True), spy(mlp, False), spy(moe, True), \
            torch.inference_mode():
        y = transformer._unit_apply(unit, x, **kw)[0]
    return y, sum(parts)


def check_unit_layers(torch, cfg, params, batch, served=None) -> None:
    """(12c; (b) of 16-18 and 20): every layer of one kernel-route
    prefill of ``batch`` (the encoder's units, then the decoder's with the
    memory), run again from its recorded input (and the same memory) by
    the kernel route, which must give the recorded output, and under
    ``plain_kernels()``: its update by the kernel route, the sum of what
    its blocks add to the residual stream, within ``LOGIT_TOL`` of the
    plain route's largest magnitude.  The update is taken before it is
    rounded into the bf16 stream: where the stream grows to several times
    the update (``gemma3-12b``: 6-7x by layer 40), one bf16 step of the
    sum moves output minus input by up to 6% of the update, on either
    route; that difference is printed beside it, not held.  A unit of
    several layers (``gemma3-12b``'s five local and one global) is split
    into its layers by ``split_unit``, whose last output must equal the
    unit's bit for bit.  The prefill's logits must be ``served`` (the
    served run's), where given."""
    from repro_torch.models import model, transformer
    real_unit = transformer._unit_apply
    units = []

    def record_unit(unit, x, **kw):
        out = real_unit(unit, x, **kw)
        units.append((unit, x.clone(), out[0].clone(), kw))
        return out

    with patched(transformer, "_unit_apply", record_unit), \
            torch.inference_mode():
        got, _ = model.prefill(params, batch, cfg=cfg, max_len=SERVE_LEN)
    if served is not None:
        check(torch.equal(got[0].float().cpu(), served),
              "a second kernel-route prefill gave other logits than the "
              "served one")
    n_enc = cfg.n_enc_layers // cfg.pattern_len
    check(len(units) == n_enc + cfg.n_groups,
          f"{len(units)} units recorded, expected {n_enc + cfg.n_groups}")
    layers = []
    for unit, x, y, kw in units:
        if cfg.pattern_len == 1:
            layers.append((unit, kw, x, y))
            continue
        parts = split_unit(torch, cfg, unit, x, kw)
        check(torch.equal(parts[-1][3], y),
              "a unit's layers run one at a time differ from the unit")
        layers += parts
    worst = {"encode": 0.0, "prefill": 0.0}
    stream = growth = 0.0
    for unit, kw, x, y in layers:
        again, upd = layer_update(torch, unit, x, kw)
        check(torch.equal(again, y), "a layer run again by the kernel "
                                     "route gave another output")
        with plain_kernels():
            want, upd_want = layer_update(torch, unit, x, kw)
        scale = float(upd_want.abs().max())
        worst[kw["mode"]] = max(worst[kw["mode"]], float(
            (upd - upd_want).abs().max()) / scale)
        out_in = want.float() - x.float()
        stream = max(stream, float((y.float() - want.float()).abs().max())
                     / float(out_in.abs().max()))
        growth = max(growth, float(x.float().abs().max()) / scale)
    n_dec = len(layers) - n_enc
    print(f"serve: {cfg.name}: prompt {batch['inputs'].shape[1]}, "
          f"{n_enc} encoder and {n_dec} decoder layers, each from the "
          f"kernel route's input, its update by the plain route: worst max "
          f"abs diff {worst['encode']:.3e} (encoder) / {worst['prefill']:.3e}"
          f" (decoder) of the update's scale (tolerance {LOGIT_TOL}); "
          f"output minus input {stream:.3e} of its scale, the stream up to "
          f"{growth:.2f}x the update (printed, not held)")
    check(max(worst.values()) <= LOGIT_TOL,
          f"a layer's update by the kernel route differs from the plain "
          f"route's by {worst} of its scale")


def cross_cache_check(torch, cfg, params, seed: int,
                      S: int = CONSISTENCY_LEN) -> None:
    """(12d): the cross-cache plumbing in float32 at full width on a cut
    of one encoder and one decoder layer: a prefill of S - 1 tokens over
    ``SERVE_LEN`` frames, then one ``decode_step`` over the cached ``xk``
    / ``xv``, against the full forward's last two logit rows within
    ``PLUMBING_TOL`` of their scale."""
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_map
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=cfg.pattern_len, n_enc_layers=cfg.pattern_len)

    def one(tree):                  # the first group, in float32
        return tree_map(lambda a: a[:1].float(), tree)

    p32 = dict(tree_map(lambda a: a.float(), {
        k: v for k, v in params.items() if k not in ("blocks", "encoder")}),
        blocks=one(params["blocks"]),
        encoder={"blocks": one(params["encoder"]["blocks"]),
                 "final_norm": tree_map(lambda a: a.float(),
                                        params["encoder"]["final_norm"])})
    dev = params["embed"]["w"].device
    rng = np.random.default_rng([seed, 13])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))
                            .astype(np.int32)).to(dev)
    frames = torch.from_numpy(serve_frames(cfg, seed, 1)[0]).to(dev)
    with torch.inference_mode():
        t = time.perf_counter()
        full, _ = model.forward(p32, {"inputs": toks, "enc_frames": frames},
                                cfg=cfg32)
        last, cache = model.prefill(
            p32, {"inputs": toks[:, :S - 1], "enc_frames": frames},
            cfg=cfg32, max_len=S + 4)
        dec, _ = model.decode_step(
            p32, cache, toks[:, S - 1:],
            torch.full((1,), S - 1, dtype=torch.int32, device=dev),
            cfg=cfg32)
        sync(torch, dev)
    sec = time.perf_counter() - t
    check(tuple(cache["layer0"]["xk"].shape)
          == (1, 1, frames.shape[1], cfg.n_kv_heads, cfg.d_head),
          f"cross cache {tuple(cache['layer0']['xk'].shape)}")
    for label, got, want in (("prefill", last, full[:, S - 2]),
                             ("decode", dec, full[:, S - 1])):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        print(f"encdec: float32 {label} over the cached cross K/V vs "
              f"forward row: max abs err {err:.4e} (scale {scale:.4e}, "
              f"ratio {err / scale:.3e}, tolerance {PLUMBING_TOL})")
        check(bool(torch.isfinite(got).all()) and err <= PLUMBING_TOL * scale,
              f"float32 {label} differs from the forward by {err} "
              f"(scale {scale})")
    print(f"encdec: float32 cross-cache plumbing (1 encoder + 1 decoder "
          f"layer, d_model {cfg.d_model}, {frames.shape[1]} frames) at {S} "
          f"tokens {sec:.2f}s")


def encdec_phase(torch, seed: int):
    """Phase 12: ``seamless-m4t-large-v2`` at its full config in bf16:
    flash_attention at its three routes on the first layers' captured
    activations, every layer against the plain route, served with frames
    (72 launches a request), and the float32 cross-cache plumbing.
    Returns (serving launches, the flash timings by route)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    cfg, params = lm_model(torch, seed, get_config(ENCDEC_ARCH))
    prompts = serve_prompts(cfg, seed)
    frames = serve_frames(cfg, seed)
    dev = params["embed"]["w"].device
    first = {"enc_frames": torch.from_numpy(frames[0]).to(dev).to(
        torch.bfloat16)}
    n_enc = cfg.n_enc_layers // cfg.pattern_len
    launch = (fkernel, "flash_attention_fwd")
    captured = capture_calls(torch, cfg, params, prompts[0], {
        "encoder": (*launch, 0), "decoder": (*launch, n_enc),
        "cross": (*launch, n_enc + 1)}, extra=first)
    with torch.inference_mode():
        flash = {route: path_flash_times(torch, f"{ENCDEC_ARCH} {route}",
                                         captured[route])
                 for route in ("encoder", "decoder", "cross")}
    del captured
    torch.cuda.empty_cache()
    eng, reqs, launches, last_logits, steady_s = serve_family(
        torch, cfg, params, prompts, frames)
    check_unit_layers(torch, cfg, params, {
        "inputs": torch.tensor([prompts[0]], device=dev), **first},
        dict(last_logits)[len(prompts[0])])
    profile_decode(torch, eng, steady_s)
    profile_prefill(torch, cfg, params, prompts[0], extra=first)
    del eng, reqs, last_logits
    torch.cuda.empty_cache()
    cross_cache_check(torch, cfg, params, seed)
    return launches, flash


def image_path(torch, cfg, params, seed: int, n_new: int = MAX_NEW):
    """(13b): one image prompt as LLaVA-NeXT lays it out: 3,072 tokens
    with ``frontend_positions`` anyres patch positions from
    ``PATCH_START``, patch embeddings from ``seed``; ``model.prefill``
    (which splices them) and ``n_new`` greedy ``model.decode_step``s.
    ``splice_patches`` must equal a plain scatter of the projector's
    output exactly.  Returns the prefill's flash_attention launches and
    its first launch's inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.models import model, transformer
    from repro_torch.parallel.sharding import NO_PARALLEL
    dev = params["embed"]["w"].device
    rng = np.random.default_rng([seed, 14])
    T, P = LONG_PROMPTS[0], cfg.frontend_positions
    pos = torch.arange(PATCH_START, PATCH_START + P, dtype=torch.int32,
                       device=dev)[None]
    batch = {"inputs": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (1, T)).astype(np.int32)).to(dev),
             "patch_embeds": torch.from_numpy(rng.standard_normal(
                 (1, P, cfg.d_model), dtype=np.float32)).to(dev).to(
                 torch.bfloat16),
             "patch_pos": pos}
    with torch.inference_mode():
        x = transformer.embed(params, batch["inputs"], cfg=cfg,
                              pcfg=NO_PARALLEL)
        got = transformer.splice_patches(params, x, batch["patch_embeds"],
                                         pos, cfg=cfg, pcfg=NO_PARALLEL)
        fp = params["frontend"]
        proj = F.gelu(batch["patch_embeds"] @ fp["w1"],
                      approximate="tanh") @ fp["w2"]
        want = x.clone()
        want[0, pos[0].long()] = proj[0].to(x.dtype)
        check(torch.equal(got, want), "splice_patches differs from a plain "
                                      "scatter of the projector's output")
        del x, got, want, proj
        captured = capture_calls(torch, cfg, params, batch["inputs"][0]
                                 .tolist(), {"attn": (fkernel,
                                                      "flash_attention_fwd")},
                                 extra={k: batch[k] for k in
                                        ("patch_embeds", "patch_pos")})
        sync(torch, dev)
        fkernel.launches = 0
        t = time.perf_counter()
        logits, cache = model.prefill(params, batch, cfg=cfg,
                                      max_len=SERVE_LEN)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        out = [int(tok[0, 0])]
        ttft = time.perf_counter() - t
        n_prefill = fkernel.launches
        t = time.perf_counter()
        for i in range(n_new - 1):
            logits, cache = model.decode_step(
                params, cache, tok,
                torch.full((1,), T + i, dtype=torch.int32, device=dev),
                cfg=cfg)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            out.append(int(tok[0, 0]))
        dec_s = time.perf_counter() - t
    check(n_prefill == flash_per_prefill(cfg) and
          fkernel.launches == n_prefill,
          f"the image prompt launched flash_attention {n_prefill} times in "
          f"its prefill and {fkernel.launches - n_prefill} in decode")
    check(all(0 <= t_ < cfg.vocab_size for t_ in out),
          "the image prompt's tokens leave the vocabulary")
    print(f"vlm: image prompt of {T} tokens, {P} patch positions at "
          f"{PATCH_START}..{PATCH_START + P - 1}: splice_patches equals the "
          f"plain scatter exactly; ttft_s={ttft:.4f} ({T / ttft:.1f} prefill "
          f"tokens/s) decode {n_new - 1} steps {dec_s:.4f}s "
          f"({(n_new - 1) / dec_s:.1f} tokens/s); tokens {out[:8]}...; "
          f"flash_attention launches {n_prefill}")
    return n_prefill, captured["attn"]


def vlm_phase(torch, seed: int):
    """Phase 13: ``llava-next-mistral-7b`` at its full config in bf16:
    phase 7's text requests (32 flash_attention launches a prefill), an
    image prompt through ``model.prefill`` and ``decode_step``, and
    flash_attention at its shape.  Returns (serving launches, the image
    prefill's launches, the flash timings)."""
    from repro_torch.configs import get_config
    cfg, params = lm_model(torch, seed, get_config(VLM_ARCH))
    n_image, attn = image_path(torch, cfg, params, seed)
    with torch.inference_mode():
        flash = path_flash_times(torch, f"{VLM_ARCH} image prefill", attn)
    del attn
    torch.cuda.empty_cache()
    prompts = serve_prompts(cfg, seed)
    eng, reqs, launches, _, steady_s = serve_family(torch, cfg, params,
                                                    prompts)
    profile_decode(torch, eng, steady_s)
    profile_prefill(torch, cfg, params, prompts[0])
    return launches, n_image, flash


# ------------------------------------------------------------ phases 16-20
# 16-19: the four configs held last; 20: qwen2.5-3b, the launchers'
# default, held on the CPU since the LM slice and not served here before
HELD_ARCHS = ("gemma3-12b", "qwen3-8b", "deepseek-7b", "dbrx-132b",
              "qwen2.5-3b")
# (19): dbrx-132b's first 8 of its 40 layers, at full width: 8 layers
# and the embedding and head are 54.6 GB of bf16 weights; all 40 are 263
# GB, which waits for the LM mesh across cards
HELD_LAYERS = {"dbrx-132b": 8}


def plain_ends(torch, cfg, params, prompt, got) -> None:
    """The served last logits ``got`` of ``prompt`` beside a whole
    prefill under ``plain_kernels()``: printed, not held (at random
    weights a stack of 30-48 bf16 layers is chaotic under rounding,
    ``PERF.md`` section 6)."""
    from repro_torch.models import model
    dev = params["embed"]["w"].device
    with plain_kernels(), torch.inference_mode():
        want, _ = model.prefill(
            params, {"inputs": torch.tensor([prompt], device=dev)}, cfg=cfg,
            max_len=SERVE_LEN)
    want = want[0].float().cpu()
    print(f"serve: {cfg.name}: prompt {len(prompt)}: end to end, last "
          f"logits vs the plain route "
          f"{float((got - want).abs().max()) / float(want.abs().max()):.3e}"
          f" of their scale (argmax {int(got.argmax())}, "
          f"{int(want.argmax())}; printed, not held)")


def held_phase(torch, seed: int, arch: str):
    """Phases 16-20: ``arch`` at its full width in bf16 (``dbrx-132b`` at
    ``HELD_LAYERS`` of its layers), on a fresh card.  ``flash_attention``
    at the first attention layer's captured shape (``gemma3-12b``: the
    first local and the first global layer) held and timed as in phase 11
    (d); the launches of that prefill counted by layer kind (local: a
    window; global: none); phase 7's requests served (a); each layer of
    both long prompts by the kernel route against the plain route (b:
    ``check_unit_layers``, or ``check_moe_layers`` with the routing
    pinned); one profiled decode step and one profiled prefill.  Returns
    (serving launches, the flash timings by layer kind)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    cfg = get_config(arch)
    if arch in HELD_LAYERS:
        print(f"lm: {arch}: the first {HELD_LAYERS[arch]} of its "
              f"{cfg.n_layers} layers, at full width")
        cfg = cfg.replace(n_layers=HELD_LAYERS[arch])
    cfg, params = lm_model(torch, seed, cfg)
    prompts = serve_prompts(cfg, seed)
    pattern = cfg.block_pattern
    hooks = {"global": (fkernel, "flash_attention_fwd", pattern.index("A"))}
    if "L" in pattern:
        hooks["local"] = (fkernel, "flash_attention_fwd", pattern.index("L"))
    kinds = {"local": 0, "global": 0}
    real = fkernel.flash_attention_fwd

    def counting(q, k, v, *, causal, window):
        kinds["local" if window else "global"] += 1
        return real(q, k, v, causal=causal, window=window)

    with patched(fkernel, "flash_attention_fwd", counting):
        captured = capture_calls(torch, cfg, params, prompts[0], hooks)
    want = {"local": cfg.n_groups * pattern.count("L"),
            "global": cfg.n_groups * pattern.count("A")}
    print(f"lm: {arch}: flash_attention launches of the prefill by layer "
          f"kind {kinds} (expected {want})")
    check(kinds == want, f"{arch}: flash_attention launches by layer kind "
                         f"{kinds}, expected {want}")
    with torch.inference_mode():
        flash = {kind: path_flash_times(torch, f"{arch} {kind}",
                                        captured[kind])
                 for kind in sorted(hooks, reverse=True)}
    del captured
    torch.cuda.empty_cache()
    eng, reqs, launches, last_logits, steady_s = serve_family(
        torch, cfg, params, prompts)
    served = dict(last_logits)
    if cfg.family == "moe":
        check_moe_layers(torch, cfg, params, prompts, last_logits)
    else:
        dev = params["embed"]["w"].device
        for prompt in prompts[:len(LONG_PROMPTS)]:
            check_unit_layers(torch, cfg, params, {
                "inputs": torch.tensor([prompt], device=dev)},
                served[len(prompt)])
            plain_ends(torch, cfg, params, prompt, served[len(prompt)])
    profile_decode(torch, eng, steady_s)
    profile_prefill(torch, cfg, params, prompts[0],
                    key="prefill_" + arch if arch == PREFILL_ARCH else None)
    return launches, flash


# ------------------------------------------------------------ phases 14-15
MESH_LM_RANKS = 2               # gloo ranks sharing the card
MESH_STEPS = 2
# the mesh phases' rows: phase 8's 3,072 tokens.  At 3,072 the whole-tree
# step (PR 21) ran out of the 79.18 GiB of an NVIDIA H100 80GB HBM3
# (700.00 W), 37.5 GiB a rank in the backward, and ran at 2,048 (a peak
# of 35.97 GB a rank): it held the whole bf16 tree (5.38 GB) and its whole
# gradient (5.38 GB).  The step now gathers a pattern unit at a time
# inside its remat wrapper: a rank holds the whole embedding (1.31 GB)
# and its gradient, one unit of 13 layers (1,016,317,440 parameters,
# 2.03 GB) and its gradient, about 4 GB less
MESH_SEQ = 3072
MESH_PEAK_WHOLE_TREE = 35.97e9  # PR 21's peak a rank at 2,048 tokens
POD_LAYERS = 13                 # phase 15: one pattern unit of the 26 layers
# phase 14's depth: one pattern unit of the 26 layers (the whole stack's
# 2 steps took 100.4 s of a run of 1,145.4 s on a slow host, too close to
# its 1,200 s limit)
MESH_LAYERS = POD_LAYERS
# phase 15's rows: its podwise step keeps the whole cut model on each pod
# (nothing gathered), and a pod at 3,072 ran out of the card beside the
# other (37.46 GiB allocated)
POD_SEQ = 2048
# (14b): the 13-layer cut on (data, model) = (2, 1) accumulating 2
# microbatches of a global batch of 4 rows, one row a rank in each, one
# step: its checks read step 1 alone, and a second step (about 40 s of
# host-staged gathers) left the run too close to its 1,200 s
MESH_ACCUM, ACCUM_BATCH, ACCUM_STEPS = 2, 4, 1
# (14): step 1's loss within 2**-8 of itself of the single-device loss
# (bf16 activations: the two ranks' rows and the single device's batch
# round at other places), grad_norm within 1e-2 relative.  Each rank's
# gradient block is the bf16 sum of the two ranks' row gradients, which
# the reference computes on its own device as the token-weighted sum of
# the rows' gradients; the block is held to that sum (rounded to bf16)
# within one bf16 rounding, unit roundoff 2**-8, in relative L2
MESH_LOSS_REL, MESH_NORM_REL, MESH_ROWSUM_REL = 2.0 ** -8, 1e-2, 2.0 ** -8
# (15): bf16's mean within bf16 rounding of none's: each pod's value and
# the sum rounded to 8 significant bits (unit roundoff u = 2**-8), at
# most u * (2 + u) of the leaf's largest |g| over the pods, amax (and a
# float32 denormal); int8_ef's within amax / 64 of the exact mean
BF16_MEAN_REL = 2.0 ** -7 * (1 + 2.0 ** -9)
# the parts of a mesh step timed apart on the host clock (synchronised
# before and after): the functions that make_train_step calls
MESH_SPANS = (("fwd_bwd", "step", "_value_and_grad_accum"),
              ("norm", "sharded", "global_norm_sq"),
              ("update", "optim", "apply_updates"))
# inside fwd_bwd, each summed over a step: the per-unit gathers' and
# their backward reduce-scatters' wire calls (``sharded.gather_block``'s
# forward, recompute and backward), the exchanges (``sharded``'s autograd
# collectives: the MoE's ids' and aux statistics' all-gather, its
# backward's reduce-scatter, the expert all-to-all; and the vocab-split
# cross-entropy's all-gather of each row's maximum), and the tensor-
# parallel layers' sums over ``model`` (``sharded.model_sum``: their
# outputs forward and in the recompute, their inputs' gradients, the
# head's too, and the cross-entropy's sums)
EXCHANGE = ("gather_wire", "scatter_wire", "exchange_wire")
MESH_INNER = {"gather": ("gather_leaf",),
              "reduce_scatter": ("reduce_scatter_leaf",),
              "exchange": EXCHANGE,
              "tp_all_reduce": ("model_sum",)}


def mesh_lm_pcfg(mesh, **kw):
    """Phase 8's training knobs on ``mesh``."""
    from repro_torch.parallel.sharding import ParallelConfig
    return ParallelConfig(mesh=mesh, remat="full", fused_head=True,
                          head_chunk=HEAD_CHUNK, **kw)


def _rel(torch, got, want) -> float:
    """Relative L2 distance of ``got`` from ``want``, in float64."""
    want = want.to(got.device).double()
    return float((got.double() - want).norm() / want.norm().clamp_min(1e-30))


def mesh_reference(torch, cfg, seed: int, batch, tmp: Path) -> dict:
    """Phase 14's reference on the card: one single-device forward and
    backward of phase 8's kind (full remat, fused head) from ``seed``'s
    parameters on the global ``batch``, by the kernel route held to the
    plain route (``grad_check``, phase 8's bands at this length); then
    the token-weighted sum of the rows' gradients, each row as a mesh
    rank computes it.  Both gradients go to ``tmp/ref.pt`` (bf16, whole
    leaves; each rank cuts its blocks); returns the loss and the
    gradient's norm.  The card is freed after it."""
    from repro_torch.train import optim, step
    from repro_torch.utils.pytree import tree_flatten_with_paths, tree_leaves
    t = time.perf_counter()
    params, loss, grads = grad_check(torch, cfg, seed, batch, label="mesh")
    gnorm = float(optim.global_norm(grads))
    flat = tree_flatten_with_paths(grads)
    del grads
    # each rank's share of the mesh's work, on this device: the row's
    # gradient scaled by its share of the valid tokens, summed in float32
    tokens = (batch["labels"] >= 0).sum().float()
    acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
           for _, g in flat]
    for r in range(batch["labels"].shape[0]):
        row = {k: v[r:r + 1] for k, v in batch.items()}
        _, g_r = step._value_and_grad_accum(
            params, row, cfg=cfg, pcfg=train_pcfg(),
            loss_scale=(row["labels"] >= 0).sum().float() / tokens)
        for a, g in zip(acc, tree_leaves(g_r)):
            a.add_(g.float())
        del g_r
    del params
    spread = {p: _rel(torch, g, a) for (p, g), a in zip(flat, acc)}
    torch.save({"whole": {p: g.cpu() for p, g in flat},
                "rowsum": {p: a.to(g.dtype).cpu()
                           for (p, g), a in zip(flat, acc)}},
               tmp / "ref.pt")
    del acc, flat
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(spread, key=spread.get)
    print(f"mesh: single-device reference step ({cfg.name}, batch "
          f"{TRAIN_BATCH} x {batch['inputs'].shape[1]}): loss {loss:.6f} "
          f"grad_norm {gnorm:.4f}; the whole batch's gradient differs from "
          f"the token-weighted sum of its rows' by {spread[worst]:.3e} "
          f"relative L2 at most ({worst}; bf16 rounding); both on the host "
          f"in {time.perf_counter() - t:.2f}s")
    return {"loss": loss, "grad_norm": gnorm}


def accum_reference(torch, cfg, seed: int, batch, tmp: Path) -> dict:
    """(14b)'s reference on the card: the single-device step accumulating
    ``MESH_ACCUM`` microbatches of ``batch`` (phase 8's knobs) from
    ``seed``'s parameters, and what the mesh's ranks compute of it: in
    each microbatch the rows' gradients weighted by each row's share of
    its valid tokens and summed, rounded to the parameters' type as the
    reduce-scatter hands it back; the microbatches' sums averaged in
    float32.  Both gradients go to ``tmp/ref_accum.pt`` (``whole``
    rounded to the parameters' type, ``rowsumaccum`` float32); returns
    the accumulated step's loss and gradient norm."""
    from repro_torch.models import model
    from repro_torch.train import optim, step
    from repro_torch.utils.pytree import tree_flatten_with_paths, tree_leaves
    t = time.perf_counter()
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               batch["inputs"].device)
    dtypes = [p.dtype for p in tree_leaves(params)]
    (loss, _), grads = step._value_and_grad_accum(
        params, batch, cfg=cfg, pcfg=train_pcfg().with_(
            accum_steps=MESH_ACCUM))
    gnorm = float(optim.global_norm(grads))
    flat = tree_flatten_with_paths(grads)
    del grads
    acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
           for _, g in flat]
    k = batch["labels"].shape[0] // MESH_ACCUM
    for i in range(MESH_ACCUM):
        micro = {n: v[i * k:(i + 1) * k] for n, v in batch.items()}
        tokens = (micro["labels"] >= 0).sum().float()
        part = [torch.zeros_like(a) for a in acc]
        for r in range(k):
            row = {n: v[r:r + 1] for n, v in micro.items()}
            _, g_r = step._value_and_grad_accum(
                params, row, cfg=cfg, pcfg=train_pcfg(),
                loss_scale=(row["labels"] >= 0).sum().float() / tokens)
            for a, g in zip(part, tree_leaves(g_r)):
                a.add_(g.float())
            del g_r
        for a, m, dt in zip(acc, part, dtypes):
            a.add_(m.to(dt).float() / MESH_ACCUM)
        del part
    del params
    spread = {p: _rel(torch, g, a) for (p, g), a in zip(flat, acc)}
    torch.save({"whole": {p: g.to(dt).cpu()
                          for (p, g), dt in zip(flat, dtypes)},
                "rowsumaccum": {p: a.cpu() for a, (p, _) in zip(acc, flat)}},
               tmp / "ref_accum.pt")
    del acc, flat
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(spread, key=spread.get)
    print(f"mesh accum: single-device step of {cfg.name} cut to "
          f"{cfg.n_layers} layers accumulating {MESH_ACCUM} microbatches "
          f"of batch {batch['inputs'].shape[0]} x {batch['inputs'].shape[1]}"
          f": loss {float(loss):.6f} grad_norm {gnorm:.4f}; its gradient "
          f"differs from the rows' token-weighted sums averaged over the "
          f"microbatches by {spread[worst]:.3e} relative L2 at most "
          f"({worst}); {time.perf_counter() - t:.2f}s")
    return {"loss": float(loss), "grad_norm": gnorm}


def pod_single_step(torch, cfg, seed: int, tmp: Path, seq) -> float:
    """Phase 15's one-rank reference: the cut model on the card, one row
    (a pod's share), 2 steps; returns the second step's seconds."""
    from repro_torch.train import Trainer, TrainerConfig
    _, _, pipe = train_data(torch, tmp, cfg, seed, batch=1, seq=seq)
    tr = Trainer(cfg, train_pcfg(), TrainerConfig(
        steps=2, ckpt_every=2 ** 62, log_every=1, seed=seed), pipe,
        device="cuda")
    hist = tr.run(2)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return hist[1]["wall_s"] - hist[0]["wall_s"]


# _checksums widens this many 16-bit words at a time (a multiple of 15,
# so that each piece starts the strides of 3 and 5 in phase): the whole
# embedding widened at once took 4.88 GiB more on a card that phase 15's
# two pods fill
CHECKSUM_WORDS = 15 << 20


def _checksums(torch, tree) -> list:
    """Exact integer checksums of each leaf's bits (the whole leaf and two
    strided subsets of its 16-bit words), widened to int64 a piece of
    ``CHECKSUM_WORDS`` at a time."""
    from repro_torch.utils.pytree import tree_leaves
    out = []
    for x in tree_leaves(tree):
        words = x.detach().contiguous().view(-1).view(torch.int16)
        sums = [0, 0, 0]
        for i in range(0, words.numel(), CHECKSUM_WORDS):
            v = words[i:i + CHECKSUM_WORDS].long()
            sums = [a + int(b) for a, b in zip(sums, (
                v.sum(), v[::3].sum(), v[1::5].sum()))]
        out.append(sums)
    return out


def _mesh_spans(torch, spans: dict) -> contextlib.ExitStack:
    """``MESH_SPANS``' functions wrapped to append their seconds (the card
    synchronised before and after) to ``spans[name]``; the wire calls of
    ``MESH_INNER`` inside ``fwd_bwd`` (forward, recompute and backward)
    are timed the same way and each name's sum over a step appended to
    ``spans[name]`` when the step's ``fwd_bwd`` ends."""
    from repro_torch.parallel import sharded
    from repro_torch.train import optim, step
    modules = {"sharded": sharded, "step": step, "optim": optim}
    stack = contextlib.ExitStack()
    inner = dict.fromkeys(MESH_INNER, 0.0)

    def timed_call(fn, a, kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for name, mod, attr in MESH_SPANS:
        def timed(*a, _fn=getattr(modules[mod], attr), _name=name, **kw):
            out, secs = timed_call(_fn, a, kw)
            spans.setdefault(_name, []).append(secs)
            if _name == "fwd_bwd":
                for k in inner:
                    spans.setdefault(k, []).append(inner[k])
                    inner[k] = 0.0
            return out
        stack.enter_context(patched(modules[mod], attr, timed))
    for name, attrs in MESH_INNER.items():
        for attr in attrs:
            def wire(*a, _fn=getattr(sharded, attr), _name=name, **kw):
                out, secs = timed_call(_fn, a, kw)
                inner[_name] += secs
                return out
            stack.enter_context(patched(sharded, attr, wire))
    return stack


def span_parts(tr) -> str:
    """A rank's steps by part, from ``_rank_train``'s spans."""
    parts = []
    for i, (_, _, s) in enumerate(tr["steps"]):
        sp = {n: tr["spans"][n][i] for n in tr["spans"]}
        rest = s - sp["fwd_bwd"] - sp["update"]
        parts.append(
            f"step {i + 1}: fwd_bwd {sp['fwd_bwd']:.4f} (of it: " + " ".join(
                f"{n} {sp[n]:.4f}" for n in MESH_INNER)
            + f"; compute and the rest {sp['fwd_bwd'] - sum(sp[n] for n in MESH_INNER):.4f})"
            f" norm {sp['norm']:.4f} update {sp['update']:.4f} other "
            f"{rest:.4f}")
    return "; ".join(parts)


def _rank_train(torch, rank: int, seed: int, tmp: Path, cfg, seq,
                shape=(MESH_LM_RANKS, 1), run="", batch=TRAIN_BATCH,
                ref="ref.pt", steps=MESH_STEPS, **pcfg_kw) -> dict:
    """(14, 14b, 21) the model, ``steps`` steps on the ``(data, model) =
    shape`` mesh over a global batch of ``batch`` rows (phase 8's knobs and
    ``pcfg_kw``), each step's parts timed (``MESH_SPANS``, ``MESH_INNER``);
    the step-1 gradient blocks held against the reference's row sum
    (``rowsum`` + ``run`` in ``tmp / ref``, ``MESH_ROWSUM_REL``)
    and measured against its whole-batch gradient (``whole``)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel import sharded
    from repro_torch.train import Trainer, TrainerConfig, optim
    from repro_torch.utils.pytree import tree_flatten_with_paths, tree_leaves
    mesh = make_mesh_compat(shape, ("data", "model"))
    check(mesh.host_staged,
          f"rank {rank}: mesh on {mesh.device} over {mesh.backend}")
    _, _, pipe = train_data(torch, tmp / f"train{run}{rank}", cfg, seed,
                            batch=batch, seq=seq)
    t = time.perf_counter()
    trainer = Trainer(cfg, mesh_lm_pcfg(mesh, **pcfg_kw), TrainerConfig(
        steps=steps, ckpt_every=2 ** 62, log_every=1, seed=seed), pipe,
        device=mesh.device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    worst, spans, peaks, rels = {}, {}, {}, {}

    def held(params, grads, state, *a, **kw):
        if not worst:                       # step 1's gradient blocks
            # the check's float64 copies stay out of the step's peak
            peaks["before_check"] = torch.cuda.max_memory_allocated()
            want = torch.load(tmp / ref, mmap=True)
            for (path, g), s in zip(tree_flatten_with_paths(grads),
                                    tree_leaves(kw["specs"])):
                sl = sharded.block_slices(s, want["whole"][path].shape, mesh)
                for key, ref_key in (("rowsum", "rowsum" + run),
                                     ("whole", "whole")):
                    rel = _rel(torch, g, want[ref_key][path][sl])
                    rels.setdefault(key, {})[path] = rel
                    worst[key] = max(worst.get(key, (0.0, "")), (rel, path))
            del want
            peaks["check"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        return update(params, grads, state, *a, **kw)

    torch.cuda.reset_peak_memory_stats()
    base, state = torch.cuda.memory_allocated(), tree_nbytes(trainer._tree())
    trainer._step, batch_bytes = noting_batch(trainer._step)
    for k in sharded.WIRE:
        sharded.WIRE[k] = 0
    fkernel.launches = lkernel.launches = lkernel.backward_launches = 0
    with _mesh_spans(torch, spans):
        update = optim.apply_updates        # the timed one
        with patched(optim, "apply_updates", held):
            hist = trainer.run(steps)
    launches = (fkernel.launches, lkernel.launches,
                lkernel.backward_launches)
    wire = {k: v // steps for k, v in sharded.WIRE.items()}
    peak = max(peaks["before_check"], torch.cuda.max_memory_allocated())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    walls = [h["wall_s"] for h in hist]
    secs = np.diff([0.0] + walls)
    return {"build_s": build_s, "launches": launches, "wire": wire,
            "held": {**step_held(launches, steps,
                                 state + batch_bytes["batch"],
                                 peak - (base - state), secs, wire),
                     "check_peak": peaks["check"] - (base - state)},
            "mesh": "(data, model) = "
            f"{tuple(shape)}" + "".join(f", {k}={v}" for k, v in
                                        pcfg_kw.items()),
            "peak": peak, "check_peak": peaks["check"], "worst": worst,
            "rels": rels, "spans": spans,
            "steps": [(h["loss"], h["grad_norm"], s) for h, s in
                      zip(hist, secs)]}


def _rank_ckpt(torch, rank: int, seed: int, tmp: Path, cfg) -> dict:
    """(14): the reduced config trained 2 steps on the mesh and
    checkpointed at step 2 (rank 0 writes); rank 0 returns the files and
    the gathered tree."""
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel import sharded
    from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
    from repro_torch.utils.pytree import tree_flatten_with_paths
    mesh = make_mesh_compat((MESH_LM_RANKS, 1), ("data", "model"))
    small = cfg.reduced()
    client, _, pipe = train_data(torch, tmp / f"ck{rank}", small, seed,
                                 seq=128, n_tokens=20_000)
    tr = Trainer(small, mesh_lm_pcfg(mesh), TrainerConfig(
        steps=2, ckpt_every=2, log_every=1, lr=1e-3, warmup=1, seed=seed),
        pipe, SectorCheckpointer(client, "mesh"), device=mesh.device)
    tr.run(2)
    whole = sharded.gather_tree(tr._tree(), tr._specs(), tr._shapes(), mesh)
    out = {"cursor": tr.pipeline.state_dict()}
    if rank == 0:
        base = "ckpt/mesh/step_00000002"
        out["files"] = {n: client.download(n) for n in
                        (base + ".bin", base + ".manifest.json")}
        out["whole"] = {p: x.detach().float().cpu().numpy()
                        for p, x in tree_flatten_with_paths(whole)}
    return out


def _rank_pod(torch, rank: int, seed: int, tmp: Path, cfg, seq) -> dict:
    """(15) on ``(pod, data, model) = (2, 1, 1)``, the model cut to one
    pattern unit: one forward and backward on the pod's row, then
    ``cross_pod_mean`` of every mode leaf by leaf on those gradients (in
    float32, as an accumulating step makes them); then one podwise
    ``int8_ef`` step of the ``Trainer``."""
    import torch.distributed as dist

    from repro_torch.data.dataset import Cursor
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import model
    from repro_torch.parallel import collectives
    from repro_torch.train import Trainer, TrainerConfig, step
    from repro_torch.utils.pytree import tree_flatten_with_paths
    pod = make_mesh_compat((MESH_LM_RANKS, 1, 1), ("pod", "data", "model"))
    cut = cfg.replace(n_layers=POD_LAYERS)
    pcfg = mesh_lm_pcfg(pod, multi_pod=True, mode="podwise",
                        compress_pod="int8_ef")
    _, ds, pipe = train_data(torch, tmp / f"pod{rank}", cut, seed, seq=seq)
    host, _ = next(ds.batches(TRAIN_BATCH, Cursor()))
    rows = step.local_batch({k: torch.from_numpy(v) for k, v in
                             host.items()}, pcfg)
    rows = {k: v.to(pod.device) for k, v in rows.items()}
    params = model.init_params(cut, torch.Generator().manual_seed(seed),
                               pod.device)
    t = time.perf_counter()
    (loss, _), grads = step._value_and_grad_accum(
        params, rows, cfg=cut, pcfg=pcfg.with_(multi_pod=False))
    del params
    torch.cuda.synchronize()
    fwd_bwd_s = time.perf_counter() - t
    group = pod.group_for("pod")

    def exact_reduce(x, op):
        buf = x.to("cpu", copy=True)
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(x.device)

    def mean(x, mode, ef=None):
        before = collectives.WIRE["pod"]
        m, e = collectives.cross_pod_mean(
            {"w": x.clone()}, mesh=pod, compress=mode,
            ef_state=None if ef is None else {"w": ef})
        return m["w"], None if e is None else e["w"], \
            collectives.WIRE["pod"] - before

    wire = {"none": 0, "bf16": 0, "int8_ef": 0}
    worst = {"bf16": 0.0, "int8_ef": 0.0}
    ef_nonzero, n_leaves, n_elems = False, 0, 0
    t = time.perf_counter()
    for path, g in tree_flatten_with_paths(grads):
        g32 = g.float()
        n_leaves += 1
        n_elems += g32.numel()
        exact = exact_reduce(g32, dist.ReduceOp.SUM) / MESH_LM_RANKS
        none, _, b = mean(g32, "none")
        wire["none"] += b
        check(torch.equal(none, exact),
              f"rank {rank}: {path}: cross_pod_mean none differs from the "
              f"all-reduce mean")
        del exact
        amax = float(exact_reduce(g32.abs().max().reshape(1),
                                  dist.ReduceOp.MAX)[0])
        b16, _, b = mean(g32, "bf16")
        wire["bf16"] += b
        err = float((b16 - none).abs().max())
        worst["bf16"] = max(worst["bf16"], err / max(amax, 1e-30))
        check(err <= BF16_MEAN_REL * amax + 1e-38, f"rank {rank}: {path}: "
              f"bf16 mean {err} from none's, beyond bf16 rounding of the "
              f"leaf's largest |g| {amax}")
        del b16
        m8, ef, b = mean(g32, "int8_ef", torch.zeros_like(g32))
        wire["int8_ef"] += b
        err = float((m8 - none).abs().max())
        worst["int8_ef"] = max(worst["int8_ef"], err / max(amax, 1e-30))
        check(err <= amax / 64, f"rank {rank}: {path}: int8_ef mean "
              f"{err} from the exact mean, beyond amax / 64 = {amax / 64}")
        ef_nonzero |= bool(ef.any())
        del m8, ef, none, g32
    modes_s = time.perf_counter() - t
    check(ef_nonzero, f"rank {rank}: every int8_ef residual is zero")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    # one full podwise int8_ef step of the Trainer
    t = time.perf_counter()
    trainer = Trainer(cut, pcfg, TrainerConfig(
        steps=1, ckpt_every=2 ** 62, log_every=1, seed=seed), pipe,
        device=pod.device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.run(1)
    peak = torch.cuda.max_memory_allocated()
    sums = _checksums(torch, trainer.params)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss_local": float(loss), "fwd_bwd_s": fwd_bwd_s,
            "modes_s": modes_s, "wire": wire, "worst": worst,
            "leaves": n_leaves, "elems": n_elems, "build_s": build_s,
            "step": (hist[0]["loss"], hist[0]["grad_norm"],
                     hist[0]["wall_s"]),
            "peak": peak, "sums": sums}


def lm_mesh_rank(rank: int, world: int, seed: int, tmp: str, cfg,
                 seq: int) -> dict:
    """One of the 2 ranks of phases 14-15 (started by ``run_ranks``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tmp = Path(tmp)
    t = time.perf_counter()
    out = {"train": _rank_train(torch, rank, seed, tmp, cfg, seq)}
    out["train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["accum"] = _rank_train(
        torch, rank, seed, tmp, cfg.replace(n_layers=POD_LAYERS), seq,
        run="accum", batch=ACCUM_BATCH, ref="ref_accum.pt",
        steps=ACCUM_STEPS, accum_steps=MESH_ACCUM)
    out["accum_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["ckpt"] = _rank_ckpt(torch, rank, seed, tmp, cfg)
    out["ckpt_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["pod"] = _rank_pod(torch, rank, seed, tmp, cfg, POD_SEQ)
    out["pod_s"] = time.perf_counter() - t
    return out


def check_mesh_train(cfg, res, ref, key="train", passes=1,
                     falls=True) -> None:
    """Phase 14's bands, per rank, on each rank's ``res[r][key]`` (a
    row a rank and step, ``passes`` times: the microbatches); the loss
    falling where ``falls``."""
    n_attn = cfg.n_groups * sum(s in "AL" for s in cfg.block_pattern)
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    for r, out in enumerate(res):
        tr = out[key]
        want = tuple(passes * len(tr["steps"]) * n for n in
                     (2 * n_attn, 2 * n_rec, n_rec))
        loss1, norm1, _ = tr["steps"][0]
        check(abs(loss1 - ref["loss"]) <= MESH_LOSS_REL * abs(ref["loss"]),
              f"rank {r}: step-1 loss {loss1} against the single device's "
              f"{ref['loss']}")
        check(abs(norm1 - ref["grad_norm"])
              <= MESH_NORM_REL * ref["grad_norm"],
              f"rank {r}: step-1 grad_norm {norm1} against "
              f"{ref['grad_norm']}")
        rel, path = tr["worst"]["rowsum"]
        check(rel <= MESH_ROWSUM_REL,
              f"rank {r}: gradient block {path} off the single device's "
              f"sum of the rows' gradients by {rel} (relative L2; bound "
              f"{MESH_ROWSUM_REL})")
        check(tr["launches"] == want,
              f"rank {r}: launches (flash_attention, rg_lru_scan, backward) "
              f"{tr['launches']}, its rows' are {want}")
        losses = [s[0] for s in tr["steps"]]
        check(all(math.isfinite(x) for x in losses)
              and (losses[-1] < losses[0] or not falls),
              f"rank {r}: the loss did not fall: {losses}")


def report_mesh_train(label: str, cfg, tr, seq: int, rows: int,
                      card: str, before: str = "") -> None:
    """A rank's steps, peak, bytes (beside their prediction), launches,
    gradient blocks against the references, and its steps by part."""
    secs = [s for _, _, s in tr["steps"]]
    steady = statistics.median(secs[1:] or secs)
    which = "median after the first" if secs[1:] else "its only step"
    tokens = rows * seq
    print(f"{label} ({cfg.name}, {cfg.n_layers} layers, {tr['mesh']}, "
          f"gloo sharing the card, host-staged; {card}): steps "
          + ", ".join(f"loss={l:.6f} grad_norm={n:.4f} step_s={s:.4f}"
                      for l, n, s in tr["steps"])
          + f"; step_s ({which}) {steady:.4f}, "
          f"{tokens / steady:.1f} tokens/s a rank; max_memory_allocated="
          f"{tr['peak']}{f' ({before})' if before else ''} (step 1's "
          f"gradient check, kept out of it: {tr['check_peak']}); bytes a "
          f"step: "
          + " ".join(f"{k} {v}" for k, v in tr["wire"].items())
          + f" (held to the dry run's in phase 26); launches "
          f"flash_attention={tr['launches'][0]} "
          f"rg_lru_scan={tr['launches'][1]} rg_lru_scan backward="
          f"{tr['launches'][2]}; gradient blocks against the single "
          f"device's token-weighted sum of the rows' gradients: worst "
          f"{tr['worst']['rowsum'][0]:.3e} relative L2 "
          f"({tr['worst']['rowsum'][1]}; bound {MESH_ROWSUM_REL}), "
          f"against its whole-batch gradient: worst "
          f"{tr['worst']['whole'][0]:.3e} ({tr['worst']['whole'][1]}); "
          f"Trainer built in {tr['build_s']:.2f}s")
    print(f"{label} seconds by part (host clock, the card synchronised "
          f"around each; other is the rest of the step): {span_parts(tr)}")


def check_mesh_ckpt(torch, cfg, res, seed: int, tmp: Path) -> None:
    """(14): the mesh's checkpoint restores into a single-device Trainer,
    leaf for leaf."""
    from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
    from repro_torch.utils.pytree import tree_flatten_with_paths
    small = cfg.reduced()
    client, _, pipe = train_data(torch, tmp / "restore", small, seed,
                                 seq=128, n_tokens=20_000)
    for name, data in res[0]["ckpt"]["files"].items():
        client.upload(name, data, replication=2)
    tr = Trainer(small, train_pcfg(), TrainerConfig(
        steps=2, ckpt_every=2, log_every=1, lr=1e-3, warmup=1, seed=seed),
        pipe, SectorCheckpointer(client, "mesh"), device="cuda")
    check(tr.step_idx == 2, f"restored step {tr.step_idx}, not 2")
    check(tr.pipeline.state_dict() == res[0]["ckpt"]["cursor"],
          "the restored cursor differs from the mesh's")
    got = {p: x.detach().float().cpu().numpy() for p, x in
           tree_flatten_with_paths(tr._tree())}
    want = res[0]["ckpt"]["whole"]
    check(set(got) == set(want)
          and all(np.array_equal(got[p], want[p]) for p in want),
          "the single-device Trainer's restored tree differs from the "
          "mesh's gathered tree")
    print(f"mesh: checkpoint at step 2 written by the 2-rank mesh "
          f"({small.name}, rank 0 writes) restored into a single-device "
          f"Trainer: {len(want)} leaves bit-identical, cursor equal")


def check_pod(res) -> None:
    """Phase 15's bands."""
    for r, out in enumerate(res):
        p = out["pod"]
        w = p["wire"]
        check(w["bf16"] * 2 == w["none"]
              and (w["int8_ef"] - 4 * p["leaves"]) * 4 == w["none"],
              f"rank {r}: bytes over pod none / bf16 / int8_ef {w} are not "
              f"4 : 2 : 1 (+ 4 bytes a leaf of int8 scale)")
        check(math.isfinite(p["step"][0]),
              f"rank {r}: the podwise step's loss {p['step'][0]}")
    check(res[0]["pod"]["sums"] == res[1]["pod"]["sums"],
          "the two pods hold different parameters after the podwise step")


def mesh_lm_run(torch, seed: int, seq=MESH_SEQ):
    """Phases 14-15 up to their checks: the single-device references in
    this process, then the 2 ranks.  Returns (cfg, reference, one-rank
    step seconds, the ranks' results, seconds with the spawn)."""
    from repro_torch.configs import get_config
    from repro_torch.data.dataset import Cursor
    from repro_torch.launch.mesh import run_ranks
    cfg = get_config(LM_ARCH).replace(n_layers=MESH_LAYERS)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_"))
    try:
        _, ds, _ = train_data(torch, tmp / "ref", cfg, seed, seq=seq)
        host, _ = next(ds.batches(TRAIN_BATCH, Cursor()))
        ref = mesh_reference(torch, cfg, seed, {
            k: torch.from_numpy(v).cuda() for k, v in host.items()}, tmp)
        cut = cfg.replace(n_layers=POD_LAYERS)
        _, ds, _ = train_data(torch, tmp / "ref_accum", cut, seed,
                              batch=ACCUM_BATCH, seq=seq)
        host, _ = next(ds.batches(ACCUM_BATCH, Cursor()))
        ref["accum"] = accum_reference(torch, cut, seed, {
            k: torch.from_numpy(v).cuda() for k, v in host.items()}, tmp)
        single_s = pod_single_step(torch, cut, seed, tmp / "single",
                                   POD_SEQ)
        print(f"mesh: one-rank step of {cut.name} cut to {POD_LAYERS} layers "
              f"(one row of {POD_SEQ}): {single_s:.4f}s")
        fresh_card(torch, "14-15", "before the ranks start")
        t = time.perf_counter()
        res = run_ranks(lm_mesh_rank, MESH_LM_RANKS,
                        (seed, str(tmp), cfg, seq),
                        timeout_s=600, join_timeout_s=900)
        spawn_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return cfg, ref, single_s, res, spawn_s


def mesh_lm_phase(torch, seed: int) -> tuple:
    """Phases 14-15.  Returns each rank's (flash, scan, scan backward)
    launches of phase 14's run and of its accumulation run (14b)."""
    from repro_torch.parallel.collectives import pod_efficiency_ratio
    seq = MESH_SEQ
    cfg, ref, single_s, res, spawn_s = mesh_lm_run(torch, seed, seq)
    cut = cfg.replace(n_layers=POD_LAYERS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_mesh_") as tmp:
        tmp = Path(tmp)
        card = card_line()
        for r, out in enumerate(res):
            report_mesh_train(
                f"mesh train rank {r}/{MESH_LM_RANKS}", cfg, out["train"],
                seq, 1, card, f"the whole-tree step's peak a rank at 2,048 "
                f"tokens and 26 layers, PR 21: {MESH_PEAK_WHOLE_TREE:.4g}")
        check_mesh_train(cfg, res, ref)
        print(f"mesh train: step-1 loss {res[0]['train']['steps'][0][0]:.6f} "
              f"against the single device's {ref['loss']:.6f}, grad_norm "
              f"{res[0]['train']['steps'][0][1]:.4f} against "
              f"{ref['grad_norm']:.4f}")
        for r, out in enumerate(res):
            report_mesh_train(f"mesh accum rank {r}/{MESH_LM_RANKS}", cut,
                              out["accum"], seq, ACCUM_BATCH
                              // MESH_LM_RANKS, card)
        # (the cut model's loss is held to the reference's, not to fall:
        # its first step moves few of its bf16 weights)
        check_mesh_train(cut, res, ref["accum"], key="accum",
                         passes=MESH_ACCUM, falls=False)
        print(f"mesh accum: step-1 loss "
              f"{res[0]['accum']['steps'][0][0]:.6f} against the single "
              f"device's accumulated step's {ref['accum']['loss']:.6f}, "
              f"grad_norm {res[0]['accum']['steps'][0][1]:.4f} against "
              f"{ref['accum']['grad_norm']:.4f}")
        check_mesh_ckpt(torch, cfg, res, seed, tmp)
        check_pod(res)
        for r, out in enumerate(res):
            p = out["pod"]
            loss, norm, step_s = p["step"]
            print(f"mesh pod rank {r}/{MESH_LM_RANKS} ({cut.name} cut to "
                  f"{POD_LAYERS} layers, (pod, data, model) = (2, 1, 1), "
                  f"{p['leaves']} leaves, {p['elems']} parameters; {card}): "
                  f"forward+backward {p['fwd_bwd_s']:.2f}s; cross_pod_mean "
                  f"of the float32 gradients leaf by leaf, three modes "
                  f"{p['modes_s']:.2f}s: bytes over pod none "
                  f"{p['wire']['none']} bf16 {p['wire']['bf16']} int8_ef "
                  f"{p['wire']['int8_ef']}; none equal to the all-reduce "
                  f"mean; bf16 worst {p['worst']['bf16']:.4e} of amax (bound "
                  f"{BF16_MEAN_REL:.4e}); int8_ef worst "
                  f"{p['worst']['int8_ef']:.4e} of amax (bound 1/64); "
                  f"podwise int8_ef Trainer step: loss={loss:.6f} "
                  f"grad_norm={norm:.4f} step_s={step_s:.4f} "
                  f"max_memory_allocated={p['peak']}; "
                  f"pod_efficiency_ratio {pod_efficiency_ratio(step_s, single_s):.4f}"
                  f" (a gloo-on-one-card figure: both pods share the card "
                  f"and stage through the host)")
        print(f"mesh: phases 14-15 ranks: train {res[0]['train_s']:.1f}s, "
              f"accum {res[0]['accum_s']:.1f}s, checkpoint "
              f"{res[0]['ckpt_s']:.1f}s, pod {res[0]['pod_s']:.1f}s;"
              f" {spawn_s:.1f}s with the spawn; the pods hold equal "
              f"parameters after the podwise step")
    MEASURED["train_mesh"] = ranks_held(res, "train")
    MEASURED["train_mesh_accum"] = ranks_held(res, "accum")
    return ([out["train"]["launches"] for out in res],
            [out["accum"]["launches"] for out in res])


# ------------------------------------------------------------ phase 21
# of qwen3-moe-30b-a3b's 48, full width (2 layers took 149.3 s of a run of
# 1,145.4 s on a slow host)
MESH_MOE_LAYERS = 1
MESH_MOE_SEQ = 2048             # a rank's row
MESH_MOE_PEAK_WHOLE_TREE = 23.68e9  # PR 23's peak a rank
# run: (mesh shape over (data, model), layout, moe_dispatch)
MESH_MOE_RUNS = {"tp": ((2, 1), "tp", "einsum"),
                 "a2a": ((1, 2), "fsdp", "a2a")}


class ThreadRanks:
    """One emulated batch rank of a mesh's MoE layers, run by a thread of
    this process on its own device (``moe.MeshRanks``' interface): the
    collectives are made of the threads' own tensors, joined in one
    autograd graph, a barrier between; ``size`` ranks, this one at
    ``index``, ``model_size`` of them along ``model`` (1, or all)."""

    def __init__(self, shared, index: int, size: int, model_size: int):
        self.shared, self.index, self.size = shared, index, size
        self.model_size = model_size
        self.model_index = index if model_size > 1 else 0

    def _swap(self, x) -> list:
        sh = self.shared
        sh.slots[self.index] = x
        sh.barrier.wait()
        got = list(sh.slots)
        sh.barrier.wait()
        return got

    def gather(self, x):
        import torch
        return torch.cat(self._swap(x))

    def exchange(self, x):
        import torch
        return torch.stack([g[self.model_index] for g in self._swap(x)])


def emulated_rows(torch, cfg, params, batch, pcfg, size: int,
                  model_size: int):
    """What ``size`` mesh ranks compute, on this device: thread ``r`` runs
    ``loss_fn`` on the batch's ``r``-th block of rows with its own
    aliases of the parameters, its MoE layers' collectives made by
    :class:`ThreadRanks` (``pcfg`` without remat: the one backward runs
    in this thread); one backward of the token-weighted sum of the ranks'
    losses.  Returns (the global loss as the mesh reports it, each leaf's
    gradient as the float32 sum of the ranks')."""
    import threading
    from types import SimpleNamespace

    from repro_torch.models import model, moe
    from repro_torch.utils.pytree import (tree_flatten_with_paths,
                                          tree_unflatten)
    flat = [p for _, p in tree_flatten_with_paths(params)]
    n = batch["labels"].shape[0] // size
    tokens = (batch["labels"] >= 0).sum().float()
    shared = SimpleNamespace(slots=[None] * size,
                             barrier=threading.Barrier(size, timeout=600))
    local = threading.local()
    outs, errors = [None] * size, []

    def rank(r):
        local.ranks = ThreadRanks(shared, r, size, model_size)
        try:
            leaves = [p.detach().requires_grad_() for p in flat]
            rows = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
            loss, metrics = model.loss_fn(tree_unflatten(params, leaves),
                                          rows, cfg=cfg, pcfg=pcfg)
            share = (rows["labels"] >= 0).sum().float() / tokens
            outs[r] = (leaves, loss, metrics["aux_loss"], share)
        except Exception as e:       # the others leave the barrier too
            errors.append(e)
            shared.barrier.abort()

    with patched(moe, "_batch_ranks", lambda _: local.ranks):
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(size)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    total = sum(share * loss for _, loss, _, share in outs)
    grads = torch.autograd.grad(total, [x for o in outs for x in o[0]],
                                materialize_grads=True)
    L = len(flat)
    acc = [sum(grads[r * L + i].float() for r in range(size))
           for i in range(L)]
    aux = outs[0][2].detach()
    loss = float(sum(share * (loss.detach() - aux)
                     for _, loss, _, share in outs) + aux)
    return loss, acc


def moe_mesh_reference(torch, cfg, seed: int, batch, tmp: Path):
    """Phase 21's references on the card.  (a) one single-device forward
    and backward on the global ``batch`` by the kernel route, held to the
    plain route (``grad_check``, phase 8's bands) at the mesh's 2,048-token
    rows; ``flash_attention`` at a row's shape, captured there, held and
    timed.  Then each run's row sum (:func:`emulated_rows`): the ranks'
    rows as the mesh computes them, positions and aux over the whole
    batch (tp) or each rank's tokens routed as its own group, the aux
    over both (a2a).  The whole-batch gradient and both row sums go to
    ``tmp/ref.pt`` (bf16, whole leaves).  Returns ({run: the emulation's
    loss and gradient norm, which the mesh's step 1 is held to}, the
    flash timings)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.train import optim
    from repro_torch.utils.pytree import tree_flatten_with_paths
    t = time.perf_counter()
    got = {}
    real = fkernel.flash_attention_fwd

    def spy(q, k, v, **kw):      # the first layer's forward, one row
        if not got:
            got["attn"] = (tuple(x[:1].detach().clone() for x in (q, k, v)),
                           kw)
        return real(q, k, v, **kw)

    with patched(fkernel, "flash_attention_fwd", spy):
        params, loss, grads = grad_check(torch, cfg, seed, batch,
                                         label="mesh moe")
    with torch.inference_mode():
        flash = path_flash_times(torch, f"{cfg.name} training row",
                                 got["attn"])
    del got
    flat = tree_flatten_with_paths(grads)
    whole_norm = float(optim.global_norm(grads))
    save = {"whole": {p: g.cpu() for p, g in flat}}
    refs = {}
    del grads
    for run, ((d, m), layout, dispatch) in MESH_MOE_RUNS.items():
        r0 = time.perf_counter()
        pcfg = train_pcfg().with_(remat="none", layout=layout,
                                  moe_dispatch=dispatch)
        e_loss, acc = emulated_rows(torch, cfg, params, batch, pcfg, d * m,
                                    m if layout == "fsdp" else 1)
        e_norm = math.sqrt(sum(float(a.double().square().sum())
                               for a in acc))
        spread = {p: _rel(torch, g, a) for (p, g), a in zip(flat, acc)}
        worst = max(spread, key=spread.get)
        save["rowsum" + run] = {p: a.to(g.dtype).cpu()
                                for (p, g), a in zip(flat, acc)}
        del acc
        torch.cuda.empty_cache()
        refs[run] = {"loss": e_loss, "grad_norm": e_norm}
        print(f"mesh moe: ({d}, {m}) {layout} {dispatch}: the ranks' rows "
              f"emulated on the card: loss {e_loss:.6f} (whole batch "
              f"{loss:.6f}) grad_norm {e_norm:.4f} (whole batch "
              f"{whole_norm:.4f}); the whole batch's gradient "
              f"differs from the token-weighted sum of the rows' by "
              f"{spread[worst]:.3e} relative L2 at most ({worst}); "
              f"{time.perf_counter() - r0:.2f}s")
    del params, flat
    t_save = time.perf_counter()
    torch.save(save, tmp / "ref.pt")
    del save
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh moe: references in {time.perf_counter() - t:.2f}s "
          f"(written to the temporary directory in "
          f"{time.perf_counter() - t_save:.2f}s)")
    return refs, flash


def moe_mesh_rank(rank: int, world: int, seed: int, tmp: str, cfg, seq: int,
                  run: str) -> dict:
    """One of the 2 ranks of phase 21's ``run`` (started by
    ``run_ranks``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    shape, layout, dispatch = MESH_MOE_RUNS[run]
    t = time.perf_counter()
    out = {"train": _rank_train(torch, rank, seed, Path(tmp), cfg, seq,
                                shape=shape, run=run, layout=layout,
                                moe_dispatch=dispatch)}
    out["run_s"] = time.perf_counter() - t
    return out


def moe_mesh_phase(torch, seed: int) -> tuple:
    """Phase 21: ``qwen3-moe-30b-a3b`` at full width cut to
    ``MESH_MOE_LAYERS`` layers trained on two gloo ranks sharing the card,
    each run (``MESH_MOE_RUNS``) spawning fresh ranks after the references
    (:func:`moe_mesh_reference`).  Returns ({path: the ranks'
    flash_attention launches}, the flash timings at a row's shape)."""
    from repro_torch.configs import get_config
    from repro_torch.data.dataset import Cursor
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_leaves
    full = get_config(MOE_ARCH)
    cfg = full.replace(n_layers=MESH_MOE_LAYERS)
    n_params = sum(math.prod(s.shape) for s in
                   tree_leaves(model.param_shapes(cfg)))
    seq = MESH_MOE_SEQ
    print(f"mesh moe: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts of width {cfg.moe_d_ff}, top-"
          f"{cfg.top_k}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.d_head}), cut to {cfg.n_layers} of {full.n_layers} layers: "
          f"{n_params} parameters, {16 * n_params} bytes of training state "
          f"at 16 bytes a parameter; global batch {TRAIN_BATCH} x {seq}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_mesh_"))
    res, spawn = {}, {}
    try:
        _, ds, _ = train_data(torch, tmp / "ref", cfg, seed, seq=seq)
        host, _ = next(ds.batches(TRAIN_BATCH, Cursor()))
        refs, flash = moe_mesh_reference(torch, cfg, seed, {
            k: torch.from_numpy(v).cuda() for k, v in host.items()}, tmp)
        for run in MESH_MOE_RUNS:
            fresh_card(torch, 21, f"before the {run} ranks start")
            t = time.perf_counter()
            res[run] = run_ranks(moe_mesh_rank, MESH_LM_RANKS,
                                 (seed, str(tmp), cfg, seq, run),
                                 timeout_s=600, join_timeout_s=900)
            spawn[run] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = card_line()
    launches = {}
    for run in MESH_MOE_RUNS:
        for r, out in enumerate(res[run]):
            report_mesh_train(
                f"mesh moe {run} rank {r}/{MESH_LM_RANKS}", cfg,
                out["train"], seq, 1, card, "the whole-tree step's at 2 layers, "
                f"PR 23: {MESH_MOE_PEAK_WHOLE_TREE:.4g}")
        check_mesh_train(cfg, res[run], refs[run])
        loss1, norm1, _ = res[run][0]["train"]["steps"][0]
        print(f"mesh moe {run}: step-1 loss {loss1:.6f} against the "
              f"single device's {refs[run]['loss']:.6f}, grad_norm "
              f"{norm1:.4f} against "
              f"{refs[run]['grad_norm']:.4f}; ranks {res[run][0]['run_s']:.1f}s, "
              f"{spawn[run]:.1f}s with the spawn")
        launches["mesh_moe_" + run] = sum(out["train"]["launches"][0]
                                          for out in res[run])
        MEASURED["mesh_moe_" + run] = ranks_held(res[run], "train")
    return launches, flash


# ------------------------------------------------------------ phase 22
# the configs served on the mesh, at full width and cut in depth (the full
# stacks took 56-80 s of a whole run of 837-1,063 s, too close to its
# 1,200 s limit): recurrentgemma-2b's first pattern unit, qwen2.5-3b's
# first 9 of 36 layers (18 took 54.3 s with phase 27 beside it)
MESH_SERVE_LAYERS = {LM_ARCH: POD_LAYERS, "qwen2.5-3b": 9}
MESH_SERVE_SHAPE = (1, 2)       # (data, model): two gloo ranks, layout tp
# (22c): served a second time by the same ranks under
# embed_mode="vocab_parallel" (the masked take of a rank's rows of the
# table, summed over model), its logits held bit for bit to the gather
# run's
MESH_VP_ARCH = "qwen2.5-3b"
# (22a): a layer's update on the mesh against the single device's from
# the same bf16 input, of the single device's largest |update|.  Each of
# the layer's two blocks (attention or RG-LRU, then the FFN) ends in a
# product through rows that the mesh splits: each rank's partial product
# is rounded to bf16 and the two are added in bf16, where the single
# device rounds the whole sum once, so each block's output moves by up
# to u (|p_0| + |p_1| + 2 |o|) with u = 2**-8 (the partials no larger
# than the output's scale: 4u of it); the FFN's input carries the
# attention block's difference, rounded into the bf16 stream: 8u = 2**-5
TP_LAYER_TOL = 2.0 ** -5
# (27a): a decoder layer with a cross block ends three such blocks (self-
# and cross-attention, FFN), each adding 4u: 12u
TP_CROSS_LAYER_TOL = 1.5 * TP_LAYER_TOL

# ------------------------------------------------------------ phase 27
# the families the serving mesh once refused, at full width: the MoE at 2
# of its 48 layers (64 of its 128 experts a rank), the encoder-decoder at
# 6 of its 24 encoder and 24 decoder layers (8 of 16 heads a rank), the
# xLSTM's first pattern unit (8 of 48 layers, whole on every rank) with
# short prompts (its sLSTM loops over every token)
MESH_FAMILY_CUTS = {MOE_ARCH: {"n_layers": 2},
                    ENCDEC_ARCH: {"n_layers": 6, "n_enc_layers": 6},
                    XLSTM_ARCH: {"n_layers": 8}}
MESH_SHORT_PROMPTS = (16, 96, 200, 512)


def family_cfgs() -> list:
    """Phase 27's configs: each of ``MESH_FAMILY_CUTS`` cut in depth."""
    from repro_torch.configs import get_config
    return [get_config(a).replace(**cut) for a, cut in
            MESH_FAMILY_CUTS.items()]


def serve_mesh_prompts(cfg, seed: int, lengths=None) -> list:
    """Phases 22 and 27's 4 requests: prompts of ``LONG_PROMPTS`` lengths
    (past the 2,048 window), twice (the xLSTM's ``MESH_SHORT_PROMPTS``),
    or of ``lengths``, tokens from ``seed``."""
    rng = np.random.default_rng([seed, 22])
    lengths = lengths or (MESH_SHORT_PROMPTS if cfg.family == "xlstm"
                          else LONG_PROMPTS * 2)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def serve_mesh_frames(cfg, seed: int, n: int):
    """The requests' encoder frames (``serve_frames``, ``SERVE_LEN`` rows
    each), or None without an encoder."""
    if not cfg.is_encoder_decoder:
        return None
    return serve_frames(cfg, seed, n, rows=SERVE_LEN)


def frames_batch(torch, frames, dev) -> dict:
    """A request's ``enc_frames`` as the engine hands them to the prefill
    (bf16 on the device), or nothing."""
    if frames is None:
        return {}
    return {"enc_frames": torch.as_tensor(frames).to(dev).to(torch.bfloat16)}


def block_update(torch, unit, x, kw, forced=None):
    """(the float32 sum of what a one-layer unit's blocks (attention,
    RG-LRU, FFN, MoE, mLSTM, sLSTM) add to the residual stream from ``x``,
    each before it is rounded into the bf16 stream (``layer_update`` with
    the RG-LRU and xLSTM blocks); the MoE block's input).  ``forced``
    (the single device's MoE input) replaces the MoE block's input, so
    that the rank routes the tokens as the single device did: the
    attention block's rounding cannot move a token across a near-tie of
    its top-k."""
    from repro_torch.models import (attention, mlp, moe, rglru, transformer,
                                    xlstm)
    parts, moe_in = [], []

    def spy(module, name, pair):
        real = getattr(module, name)

        def call(*args, **kw_):
            if module is moe:
                if forced is not None:
                    args = (args[0], forced.to(args[1].device)) + args[2:]
                moe_in.append(args[1].cpu())
            out = real(*args, **kw_)
            parts.append((out[0] if pair else out).float())
            return out
        return patched(module, name, call)

    with spy(attention, "apply", True), spy(mlp, "apply", False), \
            spy(rglru, "apply", True), spy(moe, "apply", True), \
            spy(xlstm, "mlstm_apply", True), \
            spy(xlstm, "slstm_apply", True), torch.inference_mode():
        transformer._unit_apply(unit, x, **kw)
    return sum(parts), (moe_in[0] if moe_in else None)


def one_layer_kw(cfg, sym: str, pcfg, T: int, dev, mode: str = "prefill",
                 memory=None) -> dict:
    """``_unit_apply``'s keywords for one layer ``sym`` run alone in a
    prefill (or an encoder's ``mode="encode"``) of ``T`` tokens (as
    ``split_unit`` cuts a unit), over the encoder ``memory`` if any."""
    import torch
    kw = {"cfg": cfg.replace(block_pattern=(sym,), n_layers=cfg.n_groups),
          "pcfg": pcfg, "mode": mode, "max_len": SERVE_LEN,
          "positions": torch.arange(T, dtype=torch.int32,
                                    device=dev)[None]}
    if memory is not None:
        kw["memory"] = memory.to(dev)
    return kw


def unit_layer_records(torch, cfg, params, prompt, frames=None) -> list:
    """(22a, 27a)'s single-device side: each stack's first pattern unit's
    input in a prefill of ``prompt`` (an encoder-decoder's encoder, from
    ``frames``, then its decoder over the encoder memory), then each of
    its layers run alone from the single device's input to it: [(stack,
    layer index, input, memory, update, MoE input)]."""
    from repro_torch.models import model, transformer
    from repro_torch.parallel.sharding import NO_PARALLEL
    from repro_torch.utils.pytree import tree_map
    dev = params["embed"]["w"].device
    real = transformer._unit_apply
    got = {}

    def first(unit, x, **kw):
        mem = kw.get("memory")
        got.setdefault(kw["mode"], (x.clone(), None if mem is None
                                    else mem.clone()))
        return real(unit, x, **kw)

    with patched(transformer, "_unit_apply", first), torch.inference_mode():
        model.prefill(params, {"inputs": torch.tensor([prompt], device=dev),
                               **frames_batch(torch, frames, dev)},
                      cfg=cfg, max_len=SERVE_LEN)
    stacks = (("encoder", "encode"),) if cfg.is_encoder_decoder else ()
    out = []
    for stack, mode in stacks + (("blocks", "prefill"),):
        blocks = params["encoder"]["blocks"] if stack == "encoder" \
            else params["blocks"]
        unit = tree_map(lambda a: a[0], blocks)
        x, memory = got[mode]
        for i, sym in enumerate(cfg.block_pattern):
            one = {"layer0": unit[f"layer{i}"]}
            kw = one_layer_kw(cfg, sym, NO_PARALLEL, x.shape[1], dev, mode,
                              memory)
            with torch.inference_mode():
                y = transformer._unit_apply(one, x, **kw)[0]
            update, moe_in = block_update(torch, one, x, kw)
            out.append((stack, i, x.cpu(), None if memory is None
                        else memory.cpu(), update.cpu(), moe_in))
            x = y
    return out


def threaded_serve(torch, cfg, params, prompts, first_tokens,
                   frames=None, size=MESH_SERVE_SHAPE[1]) -> dict:
    """(22b, 27b)'s reference: the serving mesh's ranks emulated by
    threads of this process on its device, as ``emulated_rows`` emulates
    a training mesh.  Thread ``r`` holds rank ``r``'s serving parameters
    (its blocks of the leaves the layers compute on, cut from ``params``;
    every other leaf shared whole) and its cache blocks, prefills each
    prompt (with its ``frames``) into its slot with
    ``step.make_prefill_step`` and runs one ``step.make_decode_step`` with
    ``first_tokens``; its sums and all-gathers over ``model``
    (``sharded.model_sum``, ``gather_wire``) exchange the threads'
    tensors, summed in their type in gloo's ring order
    (:func:`ring_sum`), as the ranks' all-reduce sums them (``size``
    ranks: threads).  Returns rank 0's
    prefill logits ``[n, V]`` and first decode step's logits ``[slots,
    V]``."""
    import threading
    from types import SimpleNamespace

    import torch.distributed as dist

    from repro_torch.models import model
    from repro_torch.parallel import sharded
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
    from repro_torch.serve import ServeEngine
    from repro_torch.train import step
    from repro_torch.utils.pytree import (tree_flatten_with_paths,
                                          tree_map_with_path)
    dev = params["embed"]["w"].device
    frames = frames or [None] * len(prompts)
    shared = SimpleNamespace(slots=[None] * size,
                             barrier=threading.Barrier(size, timeout=600))
    local = threading.local()
    real_gather = sharded.gather_wire

    def swap(x) -> list:
        shared.slots[local.rank] = x
        shared.barrier.wait()
        got = list(shared.slots)
        shared.barrier.wait()
        return got

    def model_sum(x, mesh, op=dist.ReduceOp.SUM):
        # a new tensor: another thread may still read this one's x
        got = swap(x)
        if op != dist.ReduceOp.MAX:
            return ring_sum(torch, got)
        out = got[0]
        for g in got[1:]:
            out = torch.maximum(out, g)
        return out

    def gather_wire(x, mesh, axes):
        if mesh.mesh_axes(axes) != ("model",):
            return real_gather(x, mesh, axes)
        return torch.cat(swap(x))

    outs, errors = [None] * size, []

    def rank(r):
        local.rank = r
        try:
            mesh = Mesh(("data", "model"), {"data": 1, "model": size},
                        object(), r, size, dev, "gloo")
            pcfg = ParallelConfig(mesh=mesh)
            specs = dict(tree_flatten_with_paths(
                param_specs_for(model.param_shapes(cfg), pcfg)))
            mine = tree_map_with_path(
                lambda path, x: sharded.local_block(x, specs[path], mesh)
                if step.tp_leaf(path, cfg, pcfg) else x, params)
            cross = SERVE_LEN if cfg.is_encoder_decoder else 0
            with torch.inference_mode():
                prefill = step.make_prefill_step(cfg, pcfg, SERVE_LEN)
                pool = step.init_cache_blocks(cfg, pcfg, SERVE_SLOTS,
                                              SERVE_LEN, cross_len=cross)
                logits = []
                for slot, (prompt, f) in enumerate(zip(prompts, frames)):
                    lg, cache = prefill(mine, {"inputs": torch.tensor(
                        [prompt], device=dev), **frames_batch(torch, f,
                                                              dev)})
                    ServeEngine._insert(pool, cache, slot)
                    logits.append(lg[0].float().cpu())
                tok = torch.as_tensor(first_tokens, dtype=torch.int32,
                                      device=dev)[:, None]
                pos = torch.tensor([len(p) for p in prompts],
                                   dtype=torch.int32, device=dev)
                dec, _ = step.make_decode_step(cfg, pcfg, SERVE_LEN)(
                    mine, pool, tok, pos)
            outs[r] = (torch.stack(logits).numpy(), dec.float().cpu().numpy())
        except Exception as e:      # the others leave the barrier too
            errors.append(e)
            shared.barrier.abort()

    with patched(sharded, "model_sum", model_sum), \
            patched(sharded, "gather_wire", gather_wire):
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(size)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return {"emul_prefill": outs[0][0], "emul_decode": outs[0][1]}


def mesh_serve_run(torch, cfg, params, prompts, pcfg, first_tokens=None,
                   device="cuda", frames=None):
    """The requests (with their encoder ``frames``, if any) through the
    port's ``ServeEngine`` on ``pcfg`` (a mesh's blocks, or one device),
    greedy, one host-clock time a step.  Records each prefill's last
    logits, and the first decode step's logits given ``first_tokens``
    (default the engine's own), in a decode call of its own beside the
    engine's.  Returns (requests, steps, records, peak memory, the
    engine's parameters)."""
    from repro_torch.serve import SamplerConfig, ServeEngine
    eng = ServeEngine(cfg, params, pcfg, max_batch=SERVE_SLOTS,
                      max_len=SERVE_LEN, scfg=SamplerConfig(), device=device)
    rec = {"prefill": [], "decode": None, "decode_calls": 0}
    real_prefill, real_decode = eng._prefill, eng._decode

    def prefill(p, batch):
        logits, cache = real_prefill(p, batch)
        rec["prefill"].append(logits[0].float().cpu())
        return logits, cache

    def decode(p, cache, tok, pos):
        if rec["decode"] is None:
            given = tok if first_tokens is None else torch.as_tensor(
                first_tokens, dtype=tok.dtype, device=tok.device)[:, None]
            logits, _ = real_decode(p, cache, given, pos)
            rec["decode"] = logits.float().cpu()
            rec["tokens"] = given[:, 0].cpu()
            rec["decode_calls"] += 1
        rec["decode_calls"] += 1
        return real_decode(p, cache, tok, pos)

    eng._prefill, eng._decode = prefill, decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = [eng.submit(p, max_new=MAX_NEW, enc_frames=f) for p, f in
            zip(prompts, frames or [None] * len(prompts))]
    steps = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        queued = len(eng.queue)
        t = time.perf_counter()
        active = eng.step()
        steps.append((time.perf_counter() - t, queued - len(eng.queue),
                      active))
    return reqs, steps, rec, torch.cuda.max_memory_allocated(), eng.params


def lru_times(torch, label, a, b, h0) -> dict:
    """rg_lru_scan on (a, b, h0): equal to its plain version, timed as in
    phase 2 beside its bound."""
    from repro_torch.kernels.rg_lru_scan import kernel, ref
    from repro_torch.kernels.rg_lru_scan.cost import scan_cost
    got, want = kernel.lru_scan(a, b, h0), ref.lru_scan_ref(a, b, h0)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"rg_lru_scan {label} {tuple(a.shape)} differs from its plain "
          f"version")
    ms = timed_ms(torch, lambda: kernel.lru_scan(a, b, h0))
    plain = timed_ms(torch, lambda: ref.lru_scan_ref(a, b, h0))
    n_ops, n_bytes = scan_cost(a.shape)
    bnd, by = bound_ms(n_bytes, n_ops)
    print(f"kernel rg_lru_scan {label} {list(a.shape)}: kernel_ms={ms:.4f} "
          f"bound_ms={bnd:.6f} ({n_bytes} bytes; {ms / bnd:.2f}x the bound) "
          f"plain_ms={plain:.4f} max_abs_err=0")
    return {"shape": list(a.shape), "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def flash_route(q, k, causal: bool) -> str:
    """A flash_attention launch's route: a causal self-attention, an
    encoder's non-causal one, or a cross-attention (queries and keys of
    different lengths)."""
    if causal:
        return "self"
    return "encoder" if q.shape[1] == k.shape[1] else "cross"


def serve_mesh_rank(rank: int, world: int, seed: int, tmp: str, cfgs,
                    device=None) -> dict:
    """One of phase 22's (or 27's) 2 ranks (started once by
    ``run_ranks``): for each of ``cfgs`` in turn, its blocks of the
    parameters from ``seed``, the requests served on the ``(1, 2)`` mesh,
    the teacher-forced layers (22a) against the single device's records;
    rank 0 writes the first flash_attention inputs of each route and its
    first prefill and decode rg_lru_scan inputs to ``tmp``.  ``device``
    (the card by default) is the ranks' device: a CPU rehearsal passes
    ``"cpu"``.  Returns {arch: results}."""
    import torch
    from repro_torch.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat(MESH_SERVE_SHAPE, ("data", "model"),
                            device=device)
    check(mesh.host_staged or device is not None,
          f"rank {rank}: mesh on {mesh.device} over {mesh.backend}")
    out = {}
    for cfg in cfgs:
        out[cfg.name] = _serve_mesh_arch(torch, rank, mesh, seed, Path(tmp),
                                         cfg)
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.name == MESH_VP_ARCH:
            out[cfg.name]["vocab_parallel"] = _serve_mesh_vp(
                torch, mesh, seed, Path(tmp), cfg, out[cfg.name])
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _serve_mesh_vp(torch, mesh, seed: int, tmp: Path, cfg, gathered) -> dict:
    """(22c): ``cfg`` served again by this rank under
    ``embed_mode="vocab_parallel"``, the table's rows its own block (the
    masked take summed over ``model``): the prefill and first decode
    logits and the greedy streams against the ``embed_mode="gather"``
    run's (``gathered``) on the same ranks, bit for bit."""
    from repro_torch.models import model
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
    from repro_torch.utils.pytree import tree_flatten_with_paths
    pcfg = ParallelConfig(mesh=mesh, embed_mode="vocab_parallel")
    specs = dict(tree_flatten_with_paths(
        param_specs_for(model.param_shapes(cfg), pcfg)))
    params = model.init_params(
        cfg, torch.Generator().manual_seed(seed), mesh.device,
        keep=lambda path, x: sharded.local_block(x, specs[path], mesh))
    ref = torch.load(tmp / f"serve_{cfg.name}.pt")
    prompts = serve_mesh_prompts(cfg, seed)
    for k in sharded.WIRE:
        sharded.WIRE[k] = 0
    t = time.perf_counter()
    reqs, _, rec, peak, sp = mesh_serve_run(
        torch, cfg, params, prompts, pcfg, ref["tokens"], mesh.device,
        serve_mesh_frames(cfg, seed, len(prompts)))
    check(sp["embed"]["w"].shape[0] * mesh.shape["model"] == cfg.padded_vocab,
          f"{cfg.name}: the vocab_parallel rank serves with a table of "
          f"{tuple(sp['embed']['w'].shape)}, not its block of the rows")
    return {"prefill": bool(np.array_equal(
                torch.stack(rec["prefill"]).numpy(), gathered["prefill"])),
            "decode": bool(np.array_equal(rec["decode"].numpy(),
                                          gathered["decode"])),
            "tokens": [r.out for r in reqs] == gathered["tokens"],
            "table": tuple(sp["embed"]["w"].shape), "peak": peak,
            "serve_s": time.perf_counter() - t, "wire": dict(sharded.WIRE)}


def _serve_mesh_arch(torch, rank, mesh, seed: int, tmp: Path, cfg,
                     lengths=None) -> dict:
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.models import model
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
    from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map
    arch = cfg.name
    pcfg = ParallelConfig(mesh=mesh)
    specs = dict(tree_flatten_with_paths(
        param_specs_for(model.param_shapes(cfg), pcfg)))
    t = time.perf_counter()
    params = model.init_params(
        cfg, torch.Generator().manual_seed(seed), mesh.device,
        keep=lambda path, x: sharded.local_block(x, specs[path], mesh))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    ref = torch.load(tmp / f"serve_{arch}.pt")
    prompts = serve_mesh_prompts(cfg, seed, lengths)
    frames = serve_mesh_frames(cfg, seed, len(prompts))
    captured = {}
    real_flash, real_scan = fkernel.flash_attention_fwd, lkernel.lru_scan

    def flash(q, k, v, **kw):
        captured.setdefault(flash_route(q, k, kw["causal"]),
                            ((q.clone(), k.clone(), v.clone()), kw))
        return real_flash(q, k, v, **kw)

    def scan(a, b, h0):
        key = "decode" if a.shape[1] == 1 else "prefill"
        captured.setdefault(key, (a.clone(), b.clone(), h0.clone()))
        return real_scan(a, b, h0)

    tp = {"calls": 0, "s": 0.0, "gathers": 0, "gather_s": 0.0}
    real_sum, real_gather = sharded.model_sum, sharded.gather_wire

    def model_sum(x, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_sum(x, *a, **kw)
        torch.cuda.synchronize()
        tp["calls"] += 1
        tp["s"] += time.perf_counter() - t0
        return out

    def gather_wire(x, mesh_, axes):
        # the logits' gather over model (a rank's block of the vocabulary)
        if mesh_.mesh_axes(axes) != ("model",):
            return real_gather(x, mesh_, axes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_gather(x, mesh_, axes)
        torch.cuda.synchronize()
        tp["gathers"] += 1
        tp["gather_s"] += time.perf_counter() - t0
        return out

    for k in sharded.WIRE:
        sharded.WIRE[k] = 0
    fkernel.launches = lkernel.launches = 0
    t = time.perf_counter()
    with patched(fkernel, "flash_attention_fwd", flash), \
            patched(lkernel, "lru_scan", scan), \
            patched(sharded, "model_sum", model_sum), \
            patched(sharded, "gather_wire", gather_wire):
        reqs, steps, rec, peak, sp = mesh_serve_run(
            torch, cfg, params, prompts, pcfg, ref["tokens"], mesh.device,
            frames)
    serve_s = time.perf_counter() - t
    launches = (fkernel.launches, lkernel.launches)
    wire = dict(sharded.WIRE)
    # (22a): each layer of each stack's first unit from the single
    # device's input (its MoE block from the single device's MoE input)
    layers = []
    for stack, i, x, memory, want, moe_in in ref["layers"]:
        blocks = sp["encoder"]["blocks"] if stack == "encoder" \
            else sp["blocks"]
        one = {"layer0": tree_map(lambda a: a[0], blocks)[f"layer{i}"]}
        x = x.to(mesh.device)
        kw = one_layer_kw(cfg, cfg.block_pattern[i], pcfg, x.shape[1],
                          mesh.device,
                          "encode" if stack == "encoder" else "prefill",
                          memory)
        got, _ = block_update(torch, one, x, kw, moe_in)
        tol = TP_CROSS_LAYER_TOL if memory is not None else TP_LAYER_TOL
        layers.append((stack, i, float((got.cpu() - want).abs().max())
                       / float(want.abs().max()), tol))
    if rank == 0:
        torch.save({k: v for k, v in captured.items()}, tmp / f"kern_{arch}.pt")
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    return {"launches": launches, "want_launches": (
                flash_per_prefill(cfg) * len(prompts),
                n_rec * (len(prompts) + rec["decode_calls"])),
            "prefill": torch.stack(rec["prefill"]).numpy(),
            "decode": rec["decode"].numpy(),
            "tokens": [r.out for r in reqs], "ttft": [
                r.t_first - r.t_submit for r in reqs],
            "prefill_s": [r.t_first - r.t_admit for r in reqs],
            "steps": steps, "peak": peak, "wire": wire, "tp": tp,
            "serve_s": serve_s, "init_s": init_s, "layers": layers,
            "blocks": sum(x.nbytes for _, x in
                          tree_flatten_with_paths(params)),
            "serving_bytes": sum(x.nbytes for _, x in
                                 tree_flatten_with_paths(sp))}


def serve_reference(torch, cfg, seed: int, tmp: Path, card: str,
                    device="cuda", size=MESH_SERVE_SHAPE[1], lengths=None):
    """Phases 22, 27 and 28's references of ``cfg``, in this process: the
    single-device engine's requests (``serve_mesh_prompts`` of
    ``lengths``), each layer of the first unit (``unit_layer_records``)
    and ``size`` model ranks emulated by threads (``threaded_serve``),
    written to ``tmp / serve_<arch>.pt`` for the ranks.  Returns (what the
    ranks are held to, the single device's times)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.parallel.sharding import NO_PARALLEL
    arch = cfg.name
    t_arch = time.perf_counter()
    cfg, params = lm_model(torch, seed, cfg, device)
    prompts = serve_mesh_prompts(cfg, seed, lengths)
    frames = serve_mesh_frames(cfg, seed, len(prompts))
    fkernel.launches = 0
    reqs, steps, rec, peak, _ = mesh_serve_run(
        torch, cfg, params, prompts, NO_PARALLEL, device=device,
        frames=frames)
    single = {"ttft": [r.t_first - r.t_submit for r in reqs],
              "steps": steps}
    steady = [(sec, act) for sec, adm, act in steps if adm == 0]
    print(f"serve mesh: {arch} single device ({card}): ttft_s "
          f"{[round(x, 4) for x in single['ttft']]} (prompts "
          f"{[len(p) for p in prompts]}"
          + (f", {SERVE_LEN} frames each" if frames else "")
          + f") decode_tok_per_s_steady "
          f"{sum(a for _, a in steady) / sum(s for s, _ in steady):.1f}"
          f" max_memory_allocated={peak}")
    layers = unit_layer_records(torch, cfg, params, prompts[0],
                                frames and frames[0])
    emul = threaded_serve(torch, cfg, params, prompts, rec["tokens"],
                          frames, size)
    torch.save({"prefill": torch.stack(rec["prefill"]),
                "decode": rec["decode"], "tokens": rec["tokens"],
                "layers": layers}, tmp / f"serve_{arch}.pt")
    want = {"prefill": torch.stack(rec["prefill"]).numpy(),
            "decode": rec["decode"].numpy(),
            "tokens": [r.out for r in reqs], **emul}
    del params, layers, reqs, rec
    print(f"serve mesh: {arch} single device and references in "
          f"{time.perf_counter() - t_arch:.1f}s")
    return want, single


def serve_mesh_timings(torch, cfg, kern, label: str) -> dict:
    """flash_attention (each route) and rg_lru_scan (prefill, decode) at
    a serving rank's shapes, from its first launches (``kern``)."""
    arch = cfg.name
    routes = ("encoder", "cross") if cfg.is_encoder_decoder else ("self",)
    timings = {"flash": {route: path_flash_times(
        torch, f"{arch} {label} {route}", (
            tuple(x.cuda() for x in kern[route][0]), kern[route][1]))
        for route in routes if route in kern}}
    if "prefill" in kern:
        timings["scan_prefill"] = lru_times(
            torch, f"{arch} {label} prefill",
            *(x.cuda() for x in kern["prefill"]))
        timings["scan_decode"] = lru_times(
            torch, f"{arch} {label} decode",
            *(x.cuda() for x in kern["decode"]))
    return timings


def serve_mesh_phase(torch, seed: int, cfgs=None, device="cuda",
                     phase=22) -> dict:
    """Phase 22: each of ``MESH_SERVE_LAYERS`` at full width and its
    layers there (or the configs ``cfgs``: phase 27's families) served on
    two gloo ranks sharing the card at ``(data, model) = (1, 2)``, layout
    ``tp``, against the single-device engine at one seed, run first in
    this process for every config (``serve_reference``); then the ranks
    start once and serve each config in turn.  Returns {arch: (the ranks'
    flash_attention and rg_lru_scan launches, the kernels' timings at a
    rank's shapes)}.  A CPU rehearsal passes reduced ``cfgs`` and
    ``device="cpu"`` (with ``torch.cuda``'s synchronize and memory calls
    stubbed, in the ranks too, and the kernel timings skipped)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    card = card_line()
    cfgs = cfgs or [get_config(a).replace(n_layers=n)
                    for a, n in MESH_SERVE_LAYERS.items()]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_"))
    out, wants, singles = {}, {}, {}
    try:
        for cfg in cfgs:
            wants[cfg.name], singles[cfg.name] = serve_reference(
                torch, cfg, seed, tmp, card, device)
        fresh_card(torch, phase, "before the ranks start")
        t = time.perf_counter()
        res = run_ranks(serve_mesh_rank, MESH_LM_RANKS,
                        (seed, str(tmp), cfgs,
                         None if device == "cuda" else device),
                        timeout_s=600, join_timeout_s=900)
        print(f"serve mesh: the ranks served "
              f"{[c.name for c in cfgs]} in {time.perf_counter() - t:.1f}s "
              f"with their spawn")
        kerns = {c.name: torch.load(tmp / f"kern_{c.name}.pt") for c in cfgs}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for cfg in cfgs:
        arch = cfg.name
        for r, got in enumerate(res):
            check_serve_mesh_rank(arch, r, got[arch], wants[arch],
                                  singles[arch], card)
        launches = [got[arch]["launches"] for got in res]
        if device != "cuda":
            out[arch] = (launches, {})
            continue
        out[arch] = (launches, serve_mesh_timings(
            torch, cfg, kerns.pop(arch), "tensor-parallel rank"))
    return out


def check_serve_mesh_rank(arch, r, got, want, single, card,
                          shape=MESH_SERVE_SHAPE) -> None:
    """Phase 22's (and 27's, 28's) bands on rank ``r``'s results on the
    ``(data, model) = shape`` mesh, and its lines."""
    scale = float(np.abs(want["prefill"]).max())
    err_p = float(np.abs(got["prefill"] - want["prefill"]).max())
    dscale = float(np.abs(want["decode"]).max())
    err_d = float(np.abs(got["decode"] - want["decode"]).max())
    rel, stack, layer, tol = max((rel, stack, i, tol) for stack, i, rel, tol
                                 in got["layers"])
    same = sum(a == b for a, b in zip(got["tokens"], want["tokens"]))
    emul_p = float(np.abs(got["prefill"] - want["emul_prefill"]).max())
    emul_d = float(np.abs(got["decode"] - want["emul_decode"]).max())
    steady = [(sec, act) for sec, adm, act in got["steps"] if adm == 0]
    tp = got["tp"]
    print(f"serve mesh: {arch} rank {r}/{shape[0] * shape[1]} ((data, "
          f"model) = {shape}, layout tp, gloo sharing the card, "
          f"host-staged; {card}): ttft_s "
          f"{[round(x, 4) for x in got['ttft']]} (single device "
          f"{[round(x, 4) for x in single['ttft']]}) prefill_s "
          f"{[round(x, 4) for x in got['prefill_s']]} "
          f"decode_tok_per_s_steady "
          f"{sum(a for _, a in steady) / sum(s for s, _ in steady):.1f} "
          f"max_memory_allocated={got['peak']} (the rank's blocks "
          f"{got['blocks']} bytes, its serving parameters "
          f"{got['serving_bytes']}); tp_all_reduce {tp['calls']} calls "
          f"{got['wire']['tp_all_reduce']} bytes {tp['s']:.3f}s, the "
          f"logits' all_gather over model {tp['gathers']} calls "
          f"{tp['gather_s']:.3f}s, of the serve's {got['serve_s']:.3f}s "
          f"(the rest: compute, the engine and the other collectives: "
          + " ".join(f"{k} {v}" for k, v in got["wire"].items()
                     if v and k != "tp_all_reduce")
          + f" bytes); launches flash_attention={got['launches'][0]} "
          f"rg_lru_scan={got['launches'][1]}; the prefill logits "
          f"{emul_p:.3e} and the first decode step's {emul_d:.3e} from the "
          f"single device's with its model ranks emulated by threads "
          f"(scale {scale:.3f} / {dscale:.3f}; tolerance {LOGIT_TOL} of it),"
          f" {err_p:.3e} and {err_d:.3e} from the plain single device's "
          f"(printed: bf16 rounding through the random-weight stack); each "
          f"stack's first unit's layers teacher-forced: "
          + ", ".join(f"{s} {i} {x:.3e}" for s, i, x, _ in got["layers"])
          + f" of the plain single device's scale (worst {stack} layer "
          f"{layer}; tolerance {tol}); greedy streams equal to the single "
          f"device's: {same} of {len(want['tokens'])}; parameters made in "
          f"{got['init_s']:.2f}s")
    check(emul_p <= LOGIT_TOL * scale,
          f"{arch} rank {r}: prefill logits {emul_p} from the emulated "
          f"ranks'")
    check(emul_d <= LOGIT_TOL * dscale,
          f"{arch} rank {r}: the first decode step's logits {emul_d} from "
          f"the emulated ranks'")
    for s, i, x, t in got["layers"]:
        check(x <= t, f"{arch} rank {r}: {s} layer {i}'s update {x} of "
              f"its scale from the single device's (tolerance {t})")
    check(got["launches"] == got["want_launches"]
          and min(got["launches"][0], 1) == min(got["want_launches"][0], 1),
          f"{arch} rank {r}: launches (flash_attention, rg_lru_scan) "
          f"{got['launches']}, the path's are {got['want_launches']}")
    check(all(len(t) == MAX_NEW for t in got["tokens"]),
          f"{arch} rank {r}: a request ended short")
    vp = got.get("vocab_parallel")
    if vp is not None:
        print(f"serve mesh: {arch} rank {r} (22c) served again under "
              f"embed_mode=vocab_parallel (the rank's table rows "
              f"{list(vp['table'])}; {card}) in {vp['serve_s']:.3f}s, "
              f"max_memory_allocated={vp['peak']}, bytes "
              + " ".join(f"{k} {v}" for k, v in vp["wire"].items() if v)
              + f": prefill logits equal to the gather run's: "
              f"{vp['prefill']}, first decode step's: {vp['decode']}, greedy "
              f"streams: {vp['tokens']}")
        check(vp["prefill"] and vp["decode"] and vp["tokens"],
              f"{arch} rank {r}: the vocab_parallel embedding's serve "
              f"differs from the gather run's")


# gloo's ring all-reduce cuts the flattened tensor into segments, at
# least two a rank and at most GLOO_SEGMENT_BYTES each, their number a
# multiple of the ranks'; segment s is added up around the ring from rank
# s // (its segments a rank) - 1 downwards, each addition rounded in the
# tensor's type.  Its reduce-scatter keeps the rank's block of the same
# sums.  Both bit for bit on gloo ranks on the CPU at 2, 3 and 5 ranks
# (tests/test_torch_tp_recurrent.py)
GLOO_SEGMENT_BYTES = 1 << 20


def ring_sum(torch, parts):
    """The ranks' ``parts`` (a tensor a rank, of one shape and type)
    summed in their type in the order gloo's ring all-reduce adds them
    (``GLOO_SEGMENT_BYTES``); a contiguous tensor of their shape, no
    autograd."""
    size = len(parts)
    flat = [q.detach().contiguous().reshape(-1) for q in parts]
    n = flat[0].numel()
    segs = max(-(-n * flat[0].element_size() // GLOO_SEGMENT_BYTES),
               2 * size)
    segs = -(-segs // size) * size
    per, seg = segs // size, -(-n // segs)
    out = torch.empty_like(flat[0])
    for s in range(-(-n // seg) if n else 0):
        lo, hi, j = s * seg, min((s + 1) * seg, n), s // per
        acc = flat[(j - 1) % size][lo:hi]
        for t in range(2, size + 1):
            acc = acc + flat[(j - t) % size][lo:hi]
        out[lo:hi] = acc
    return out.view(parts[0].shape)


def ring_ops(torch):
    """(``add``, ``fan_out``): the emulated ranks' sums over ``model`` as
    autograd functions, added in gloo's ring order (:func:`ring_sum`).
    ``add(parts)`` is ``reduce_from_model`` over the ranks' ``parts``
    (the same gradient to each); ``fan_out(x, n)`` is ``copy_to_model``
    for ``n`` ranks: ``x`` once a rank, its gradient the ranks' gradients
    added."""
    class Add(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *parts):
            ctx.n = len(parts)
            return ring_sum(torch, parts)

        @staticmethod
        def backward(ctx, g):
            return (g,) * ctx.n

    class FanOut(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, n):
            return tuple(x.view_as(x) for _ in range(n))

        @staticmethod
        def backward(ctx, *gs):
            return ring_sum(torch, gs), None

    return (lambda parts: Add.apply(*parts)), FanOut.apply


# the leaves a tensor-parallel layer computes on its model block, and the
# dim the block cuts (the JAX specs' "model" entry)
TP_CUTS = {"attn": {"wq": 1, "bq": 0, "wo": 0},
           "kv": {"wk": 1, "wv": 1, "bk": 0, "bv": 0},
           "mlp": {"wi": 1, "wg": 1, "wo": 0},
           "rglru": {"in_x": 1, "in_g": 1, "conv_w": 1, "a_param": 0,
                     "out": 0}}


@contextlib.contextmanager
def emulated_model_ranks(torch, size: int, device):
    """What ``size`` ``model`` ranks of a ``layout="tp"`` mesh compute,
    on this device in one autograd graph, for calls off a mesh: each
    attention, dense-FFN and RG-LRU layer that would split is called once
    a rank, with the rank's blocks cut from the whole leaves (contiguous
    copies, as a rank holds them) and a stand-in mesh at the rank's
    ``model`` coordinate; ``sharded.copy_to_model`` and
    ``reduce_from_model`` are the identity inside, and the ranks' sums
    over ``model`` run as the mesh's gloo all-reduce adds them, in the
    tensors' type and in its ring order (:func:`ring_ops`): the ranks'
    outputs; the layer's input and every whole leaf it reads, which
    enter each rank's call once a rank (``fan_out``), so that each
    input's gradient is the ranks' gradients added as ``copy_to_model``'s
    all-reduce adds them.  The fused head's input enters the same way,
    once for all its chunks, as ``losses.fused_cross_entropy`` passes it
    through ``copy_to_model``; each chunk computes each rank's block of
    the vocabulary's logits and its float32 sums over the block at the
    rows' maxima (``losses._block_stats``), added as the all-reduce adds
    them.  An RG-LRU layer whose ranks' slices cross its gate blocks
    (``size`` not dividing ``N_GATE_BLOCKS``) runs each rank's conv
    first, then each rank's gates on its blocks of their concatenation,
    as the ranks' all-gather hands it to every rank
    (:func:`gathered_lru`).  The caches a prefill emits are rank 0's
    blocks (for the logits alone)."""
    from repro_torch.models import attention, losses, mlp, model, rglru
    from repro_torch.parallel import sharded
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import tp_block
    add, fan_out = ring_ops(torch)
    meshes = [Mesh(("data", "model"), {"data": 1, "model": size}, object(),
                   r, size, device, "gloo") for r in range(size)]

    def fanned(leaf) -> list:
        """A whole leaf (or a dict of them) once a rank, through
        ``fan_out``."""
        if isinstance(leaf, dict):
            per = {k: fanned(v) for k, v in leaf.items()}
            return [{k: v[r] for k, v in per.items()} for r in range(size)]
        if isinstance(leaf, torch.Tensor):
            return list(fan_out(leaf, size))
        return [leaf] * size

    def rank_params(p, tables) -> list:
        """Each rank's leaves: its blocks of those ``tables`` cut, every
        other leaf whole through ``fan_out``."""
        dims = {name: dim for table in tables for name, dim in table.items()}
        ranks = [{} for _ in range(size)]
        for name, leaf in p.items():
            if name in dims:
                n = leaf.shape[dims[name]] // size
                blocks = [leaf.narrow(dims[name], r * n, n).contiguous()
                          for r in range(size)]
            else:
                blocks = fanned(leaf)
            for r in range(size):
                ranks[r][name] = blocks[r]
        return ranks

    def wrap(module, tables_of, pair):
        real = module.apply

        def call(p, x, *a, pcfg, **kw):
            tables = None if pcfg.mesh is not None else tables_of(
                pcfg.with_(mesh=meshes[0], layout="tp"), kw)
            if not tables:
                return real(p, x, *a, pcfg=pcfg, **kw)
            outs = [real(q, xr, *a,
                         pcfg=pcfg.with_(mesh=meshes[r], layout="tp"),
                         **rank_kw(kw, r))
                    for r, (q, xr) in enumerate(zip(rank_params(p, tables),
                                                    fan_out(x, size)))]
            if not pair:
                return add(outs)
            return add([o[0] for o in outs]), outs[0][1]
        return patched(module, "apply", call)

    def rank_kw(kw, r):
        """A recurrent state (a prefill's zeros) cut to the rank's slice
        of the width."""
        if kw.get("state") is None:
            return kw
        return dict(kw, state={k: v.chunk(size, dim=-1)[r].contiguous()
                               for k, v in kw["state"].items()})

    def attn_tables(pc, kw):
        cfg = kw["cfg"]
        if kw.get("memory_kv") is not None or kw["mode"] == "encode" \
                or not tp_block(pc, cfg.n_heads):
            return None
        kv = tp_block(pc, cfg.n_kv_heads) is not None
        return [TP_CUTS["attn"]] + ([TP_CUTS["kv"]] if kv else [])

    def mlp_tables(pc, kw):
        ok = kw.get("tp", True) and tp_block(pc, kw["cfg"].d_ff)
        return [TP_CUTS["mlp"]] if ok else None

    def lru_tables(pc, kw):
        cfg = kw["cfg"]
        ok = rglru.lru_split(cfg, pc)
        return [TP_CUTS["rglru"]] if ok else None

    lru_wrap = wrap(rglru, lru_tables, True)

    def lru_call(p, x, *, cfg, pcfg, state=None, **kw):
        pc = pcfg.with_(mesh=meshes[0], layout="tp")
        if pcfg.mesh is not None or rglru.lru_split(cfg, pc) is None \
                or rglru.N_GATE_BLOCKS % size == 0:
            return ranks_lru(p, x, cfg=cfg, pcfg=pcfg, state=state, **kw)
        states = [rank_kw({"state": state}, r)["state"] for r in range(size)]
        outs = gathered_lru(torch, rank_params(p, [TP_CUTS["rglru"]]),
                            fan_out(x, size), states, fan_out)
        return add([o[0] for o in outs]), outs[0][1]

    real_fused, real_stats = losses.fused_cross_entropy, losses._chunk_stats

    def split_head(w, transpose_w):
        dim = 0 if transpose_w else 1
        return dim, (w.shape[dim] // size if w.shape[dim] % size == 0
                     else 0)

    def fused(x, w, labels, *, transpose_w, mesh=None, **kw):
        # the ranks' inputs stacked on a last dim: the chunks slice all
        if mesh is None and split_head(w, transpose_w)[1]:
            x = torch.stack(fan_out(x, size), -1)
        return real_fused(x, w, labels, transpose_w=transpose_w, mesh=mesh,
                          **kw)

    def chunk_stats(x_c, labels_c, w, *, real_vocab, transpose_w,
                    mesh=None):
        dim, n = split_head(w, transpose_w)
        if mesh is not None or not n:
            return real_stats(x_c, labels_c, w, real_vocab=real_vocab,
                              transpose_w=transpose_w, mesh=mesh)
        blocks = [losses._masked_f32(losses.head_product(
            x_c[..., r].contiguous(), w.narrow(dim, r * n, n), transpose_w),
            real_vocab, r * n) for r in range(size)]
        with torch.no_grad():       # sharded.model_argmax's pairs
            idx = [b.argmax(-1, keepdim=True) for b in blocks]
            top = torch.stack([torch.gather(b, -1, i)[..., 0] for b, i in
                               zip(blocks, idx)])
            first = top.argmax(0, keepdim=True)
            m = torch.take_along_dim(top, first, dim=0)[0]
            top = torch.take_along_dim(torch.stack([
                i[..., 0] + r * n for r, i in enumerate(idx)]), first,
                dim=0)[0]
        parts = [losses._block_stats(b, labels_c, real_vocab, r * n, m)
                 for r, b in enumerate(blocks)]
        total = add([q[0] for q in parts])
        gold = add([q[1] for q in parts])
        return losses._sums(m + torch.log(total), gold, top, labels_c)

    with wrap(attention, attn_tables, True), wrap(mlp, mlp_tables, False), \
            lru_wrap, patched(losses, "_chunk_stats", chunk_stats), \
            patched(model, "fused_cross_entropy", fused), \
            patched(sharded, "copy_to_model", lambda x, mesh: x), \
            patched(sharded, "reduce_from_model", lambda x, mesh: x):
        ranks_lru = rglru.apply      # the per-rank calls of lru_wrap
        with patched(rglru, "apply", lru_call):
            yield


def gathered_lru(torch, ps, xs, states, fan_out) -> list:
    """``rglru.apply``'s route on ranks whose slices of the width cross
    the gate blocks, emulated in one autograd graph: each rank's
    branch, gate and conv from its leaves ``ps[r]`` (its blocks, and the
    whole gates through ``fan_out``), its input ``xs[r]`` and its slice of
    the state, then each rank's gate columns
    (``rglru.rank_gate_columns``) on its blocks of every rank's conv
    output concatenated ``[W, B, T]`` (what the all-gather hands each
    rank, once a rank through ``fan_out``: the ranks' gradients of it are
    added in gloo's ring order, as its reduce-scatter adds them), the scan
    and its rows of ``out``.  Returns each rank's (partial output, new
    state or None)."""
    import torch.nn.functional as F

    from repro_torch.models import common, rglru
    size = len(ps)
    parts = []
    for q, xr, st in zip(ps, xs, states):
        branch = xr @ q["in_x"]
        gate = F.gelu((xr @ q["in_g"]).float(), approximate="tanh").to(
            xr.dtype)
        if st is None:
            xc, conv = common.causal_conv1d(branch, q["conv_w"]), None
            h0 = torch.zeros(xc.shape[::2], dtype=torch.float32,
                             device=xr.device)
        else:
            xc, conv = common.causal_conv1d(branch, q["conv_w"], st["conv"])
            h0 = st["h"]
        parts.append((xc, gate, conv, h0))
    wholes = fan_out(torch.cat([xc.movedim(-1, 0) for xc, *_ in parts]),
                     size)
    width = wholes[0].shape[0]
    block = width // rglru.N_GATE_BLOCKS
    outs = []
    for r, (q, (xc, gate, conv, h0)) in enumerate(zip(ps, parts)):
        b0, b1 = rglru.gate_span(width, r, size)
        xb = wholes[r][b0 * block:b1 * block].movedim(0, -1).contiguous()
        ga, gx = (rglru.rank_gate_columns(xb, q[name]["w"], r, size)
                  for name in ("gate_a", "gate_x"))
        y, h_t = rglru._recur(q, xc, ga, gx, h0)
        outs.append(((y * gate) @ q["out"],
                     None if conv is None else {"h": h_t, "conv": conv}))
    return outs


# ------------------------------------------------------------ run 14c
TP_TRAIN_SHAPE = (1, 2)         # (data, model), layout tp
TP_TRAIN_BATCH = 1              # one row of MESH_SEQ tokens


def tp_reference(torch, cfg, seed: int, batch, tmp: Path,
                 size=TP_TRAIN_SHAPE[1], run="tp") -> dict:
    """(14c)'s reference on the card (and phase 28's, ``size`` 5, ``run``
    ``"tp5"``): one single-device forward and backward of phase 8's kind
    on ``batch``, and the same step with its ``size`` ``model`` ranks
    emulated on this device (:func:`emulated_model_ranks`: each rank's
    partial products rounded and added where the mesh rounds and adds
    them), whose gradient the ranks' blocks are held to (``"rowsum" +
    run``); the plain step's is ``whole``.  Both go to ``tmp / ("ref_" +
    run + ".pt")`` (whole leaves, each rank cuts its blocks); returns the
    emulation's loss and gradient norm."""
    from repro_torch.models import model
    from repro_torch.train import optim, step
    from repro_torch.utils.pytree import tree_flatten_with_paths
    t = time.perf_counter()
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               batch["inputs"].device)
    (loss, _), grads = step._value_and_grad_accum(params, batch, cfg=cfg,
                                                  pcfg=train_pcfg())
    whole = {p: g.cpu() for p, g in tree_flatten_with_paths(grads)}
    plain = (float(loss), float(optim.global_norm(grads)))
    del grads
    with emulated_model_ranks(torch, size, batch["inputs"].device):
        (loss, _), grads = step._value_and_grad_accum(
            params, batch, cfg=cfg, pcfg=train_pcfg())
    gnorm = float(optim.global_norm(grads))
    emul = {p: g.cpu() for p, g in tree_flatten_with_paths(grads)}
    del params, grads
    spread = {p: _rel(torch, whole[p], emul[p]) for p in emul}
    worst = max(spread, key=spread.get)
    torch.save({"whole": whole, "rowsum" + run: emul},
               tmp / f"ref_{run}.pt")
    del whole, emul
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh tp: single-device step of {cfg.name} cut to "
          f"{cfg.n_layers} layers, batch {batch['inputs'].shape[0]} x "
          f"{batch['inputs'].shape[1]}: loss {plain[0]:.6f} grad_norm "
          f"{plain[1]:.4f}; its {size} model ranks emulated: "
          f"loss {float(loss):.6f} grad_norm {gnorm:.4f}, the gradient "
          f"{spread[worst]:.3e} relative L2 at most from the plain step's "
          f"({worst}; bf16 rounding of the ranks' partial sums); "
          f"{time.perf_counter() - t:.2f}s")
    return {"loss": float(loss), "grad_norm": gnorm}


def tp_train_rank(rank: int, world: int, seed: int, tmp: str, cfg,
                  seq: int) -> dict:
    """One of (14c)'s 2 ranks (started by ``run_ranks``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t = time.perf_counter()
    out = {"tp": _rank_train(torch, rank, seed, Path(tmp), cfg, seq,
                             shape=TP_TRAIN_SHAPE, run="tp",
                             batch=TP_TRAIN_BATCH, ref="ref_tp.pt",
                             layout="tp")}
    out["run_s"] = time.perf_counter() - t
    return out


def tp_train_phase(torch, seed: int) -> list:
    """(14c): the 13-layer cut of ``recurrentgemma-2b`` trained 2 steps on
    ``(data, model) = (1, 2)``, layout ``tp``, one row of ``MESH_SEQ``
    tokens: each rank computes the attention, FFN and RG-LRU layers on
    its ``model`` block.  Returns each rank's (flash, scan, scan
    backward) launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.dataset import Cursor
    from repro_torch.launch.mesh import run_ranks
    cut = get_config(LM_ARCH).replace(n_layers=POD_LAYERS)
    seq = MESH_SEQ
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_mesh_"))
    try:
        _, ds, _ = train_data(torch, tmp / "ref", cut, seed,
                              batch=TP_TRAIN_BATCH, seq=seq)
        host, _ = next(ds.batches(TP_TRAIN_BATCH, Cursor()))
        ref = tp_reference(torch, cut, seed, {
            k: torch.from_numpy(v).cuda() for k, v in host.items()}, tmp)
        fresh_card(torch, "14c", "before the ranks start")
        t = time.perf_counter()
        res = run_ranks(tp_train_rank, MESH_LM_RANKS,
                        (seed, str(tmp), cut, seq), timeout_s=600,
                        join_timeout_s=900)
        spawn_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = card_line()
    for r, out in enumerate(res):
        report_mesh_train(f"mesh tp rank {r}/{MESH_LM_RANKS}", cut, out["tp"],
                          seq, TP_TRAIN_BATCH, card)
    check_mesh_train(cut, res, ref, key="tp", falls=False)
    print(f"mesh tp: step-1 loss {res[0]['tp']['steps'][0][0]:.6f} against "
          f"the single device's {ref['loss']:.6f}, grad_norm "
          f"{res[0]['tp']['steps'][0][1]:.4f} against "
          f"{ref['grad_norm']:.4f}; ranks {res[0]['run_s']:.1f}s, "
          f"{spawn_s:.1f}s with the spawn")
    MEASURED["train_mesh_tp"] = ranks_held(res, "tp")
    return [out["tp"]["launches"] for out in res]


# ------------------------------------------------------------ phase 28
# recurrentgemma-2b at full width on (data, model) = (1, 5), layout tp:
# 5 divides the LRU width of 2,560, the 10 heads, d_ff 7,680 and the
# vocabulary but not the RG-LRU's 8 gate blocks, so each rank's 512
# columns cross blocks of 320 and its gates come from the conv output
# gathered over model; cut to the unit's first three layers
TP5_SHAPE = (1, 5)
TP5_CUT = {"block_pattern": ("R", "R", "L"), "n_layers": 3}
TP5_PROMPTS = (LONG_PROMPTS[0],)     # one prompt of 3,072, MAX_NEW decoded


def tp5_cfg():
    """Phase 28's config: ``LM_ARCH`` cut to ``TP5_CUT``."""
    from repro_torch.configs import get_config
    return get_config(LM_ARCH).replace(**TP5_CUT)


def tp5_rank(rank: int, world: int, seed: int, tmp: str, cfg,
             seq: int) -> dict:
    """One of phase 28's 5 ranks (started once by ``run_ranks``): the
    steps of (14c)'s kind on ``TP5_SHAPE``, then the prompt served on the
    same ranks (``_serve_mesh_arch``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh_compat
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t = time.perf_counter()
    out = {"tp5": _rank_train(torch, rank, seed, Path(tmp), cfg, seq,
                              shape=TP5_SHAPE, run="tp5",
                              batch=TP_TRAIN_BATCH, ref="ref_tp5.pt",
                              layout="tp")}
    out["train_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    mesh = make_mesh_compat(TP5_SHAPE, ("data", "model"))
    out["serve"] = _serve_mesh_arch(torch, rank, mesh, seed, Path(tmp), cfg,
                                    TP5_PROMPTS)
    out["serve_s"] = time.perf_counter() - t
    return out


def tp5_phase(torch, seed: int, device="cuda") -> dict:
    """Phase 28: ``tp5_cfg()`` trained 2 steps on one row of ``MESH_SEQ``
    tokens on ``TP5_SHAPE`` (5 gloo ranks sharing the card), held to the
    single device with the 5 ranks emulated (``tp_reference``, their sums
    in gloo's ring order; (14c)'s bands), then serving ``TP5_PROMPTS`` on the
    same ranks, held to the single device's engine with the ranks
    emulated by threads (phase 22's bands).  Returns the ranks' launches
    of both and the kernels' timings at a rank's shapes (``rg_lru_scan``
    at 512 columns, ``flash_attention`` at 2 heads of 256).  A CPU
    rehearsal passes ``device="cpu"`` (stubbed as ``serve_mesh_phase``'s,
    a config whose widths 5 divides, and the timings skipped)."""
    from repro_torch.data.dataset import Cursor
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import rglru
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig
    cfg, seq, card = tp5_cfg(), MESH_SEQ, card_line()
    size = TP5_SHAPE[0] * TP5_SHAPE[1]
    stand_in = Mesh(("data", "model"), dict(zip(("data", "model"),
                                                TP5_SHAPE)),
                    object(), 0, size, "cpu", "gloo")
    split = rglru.lru_split(cfg, ParallelConfig(mesh=stand_in))
    check(split == (0, 5) and rglru.N_GATE_BLOCKS % 5
          and rglru.gate_span(cfg.lru_width, 0, 5) == (0, 2),
          f"phase 28: the RG-LRU's route on {TP5_SHAPE} is {split}, its "
          f"rank 0's gate blocks "
          f"{rglru.gate_span(cfg.lru_width, 0, 5)}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp5_"))
    try:
        _, ds, _ = train_data(torch, tmp / "ref", cfg, seed,
                              batch=TP_TRAIN_BATCH, seq=seq)
        host, _ = next(ds.batches(TP_TRAIN_BATCH, Cursor()))
        ref = tp_reference(torch, cfg, seed, {
            k: torch.from_numpy(v).to(device) for k, v in host.items()}, tmp,
            size=TP5_SHAPE[1], run="tp5")
        want, single = serve_reference(torch, cfg, seed, tmp, card, device,
                                       size=TP5_SHAPE[1],
                                       lengths=TP5_PROMPTS)
        fresh_card(torch, 28, "before the ranks start")
        t = time.perf_counter()
        res = run_ranks(tp5_rank, size, (seed, str(tmp), cfg, seq),
                        timeout_s=600, join_timeout_s=900)
        spawn_s = time.perf_counter() - t
        kern = torch.load(tmp / f"kern_{cfg.name}.pt")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, out in enumerate(res):
        report_mesh_train(f"mesh tp5 rank {r}/{size}", cfg, out["tp5"], seq,
                          TP_TRAIN_BATCH, card)
        rels = out["tp5"]["rels"]
        print(f"mesh tp5 rank {r}/{size}: the farthest gradient blocks from "
              f"the emulated ranks' (relative L2; the plain step's beside): "
              + ", ".join(f"{path} {rels['rowsum'][path]:.3e} "
                          f"({rels['whole'][path]:.3e})" for path in
                          sorted(rels["rowsum"],
                                 key=rels["rowsum"].get)[-4:]))
    for r, out in enumerate(res):
        check_serve_mesh_rank(cfg.name, r, out["serve"], want, single, card,
                              shape=TP5_SHAPE)
    check_mesh_train(cfg, res, ref, key="tp5", falls=False)
    wire = res[0]["tp5"]["wire"]
    print(f"mesh tp5: {cfg.name} cut to {cfg.block_pattern}, step-1 loss "
          f"{res[0]['tp5']['steps'][0][0]:.6f} against the emulated ranks' "
          f"{ref['loss']:.6f}, grad_norm {res[0]['tp5']['steps'][0][1]:.4f} "
          f"against {ref['grad_norm']:.4f}; the RG-LRU's gate columns from "
          f"the conv output gathered over model (all_gather "
          f"{wire['all_gather']}"
          f" bytes a step with the head's maxima); ranks trained in "
          f"{res[0]['train_s']:.1f}s and served in {res[0]['serve_s']:.1f}s,"
          f" {spawn_s:.1f}s with the spawn ({card})")
    MEASURED["train_mesh_tp5"] = ranks_held(res, "tp5")
    return {"train": [out["tp5"]["launches"] for out in res],
            "serve": [out["serve"]["launches"] for out in res],
            "timings": serve_mesh_timings(torch, cfg, kern,
                                          "tensor-parallel rank of 5")
            if device == "cuda" else {}}


# ------------------------------------------------------------ phases 23-25
# (24): llava-next-mistral-7b at 12 of its 32 layers, at full width: at 16
# bytes a parameter (bf16 weights and gradients, float32 AdamW moments
# and master copy) 12 layers with the embedding, head and projector are
# 46.6 GB of state; all 32 are 116.4 GB, more than the card holds
TRAIN_LAYERS = {VLM_ARCH: 12}
# (25): the xLSTM's device check, card against CPU: one pattern unit (8
# layers: 7 mLSTM, 1 sLSTM) at full width in float32 (no TF32), one row
# of XLSTM_CHECK_SEQ tokens; the loss and each gradient leaf within a
# relative L2 of XLSTM_GRAD_TOL.  The row is short so that the float32
# sums' other order stays well under that bar: the random-weight stack
# amplifies rounding with the row's length (what the CPU's own gradients
# move when the embeddings move by one ulp: at most 1.9e-4 of a leaf at
# 8 tokens, 4e-3 to 6e-3 at 32 to 512; scripts/depth_divergence.py --card)
XLSTM_CHECK_SEQ = 8
XLSTM_GRAD_TOL = 1e-3
# the sLSTM's input-gate bias: a shift of it moves the stabiliser m by as
# much, so c, n, h = c / n and the loss do not depend on it, and its
# gradient is rounding alone; held below XLSTM_ZERO_TOL of the forget-gate
# bias's gradient in norm
XLSTM_ZERO_LEAF, XLSTM_ZERO_TOL = "slstm/b_i", 1e-5
# (23a, 24a): the gradient check, twice.  At full depth in float32
# (FAMILY_CHECK_DTYPE) against plain_kernels(): the routes differ by the
# kernel's float32 sums, and the SIMT kernel runs.  In bf16, the type the
# steps train in and the wgmma kernel runs in, at one pattern unit (an
# encoder-decoder's encoder as deep) against tile_p_attention(), a plain
# version that rounds p tile for tile as that kernel does.  Deeper, the
# random-weight bf16 stack parts the two routes' gradients as it parts
# any two roundings (scripts/depth_divergence.py --card)
FAMILY_CHECK_DTYPE = "float32"
# (23b-c, 24b-c): the bf16 steps.  At the Trainer's warm-up the first
# steps' learning rates are 1.5e-5 to 6e-5, and seamless's loss wanders
# there, in float32 as in bf16, before it falls (on an NVIDIA H100 80GB
# HBM3, bf16: 14.4535, 14.3858, 14.4269, 14.4780, then 14.3107 at step
# 8; float32: 14.4915, 14.4308, 14.4606, 14.4290, 14.2668 at step 8)
FAMILY_STEPS = 8


def family_batch(torch, cfg, seed: int, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                 device="cuda") -> dict:
    """A train batch of ``cfg`` from ``seed``, each entry shaped and typed
    as ``models/inputs.py``'s ``train_batch_specs`` gives it: tokens and
    their next-token labels; an encoder-decoder's ``enc_frames``; a
    vision config's ``patch_embeds``, with ``patch_pos`` at
    ``PATCH_START`` on, as ``image_path`` lays out an image prompt."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import inputs
    specs = inputs.train_batch_specs(cfg, ShapeConfig("train", seq, batch,
                                                      "train"))
    rng = np.random.default_rng([seed, 23])
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    host = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for name, spec in specs.items():
        if name in host:
            x = torch.from_numpy(host[name].copy())
        elif name == "patch_pos":
            x = torch.arange(PATCH_START, PATCH_START + spec.shape[1],
                             dtype=torch.int32).expand(spec.shape)
        else:
            x = torch.from_numpy(rng.standard_normal(
                spec.shape, dtype=np.float32)).to(spec.dtype)
        check(tuple(x.shape) == spec.shape and x.dtype == spec.dtype,
              f"{name} {tuple(x.shape)} {x.dtype}, not {spec}")
        out[name] = x.contiguous().to(device)
    return out


def family_depth(cfg, layers: int):
    """``cfg`` at its first ``layers`` layers, at most, and an
    encoder-decoder's encoder as deep."""
    layers = min(layers, cfg.n_layers)
    if cfg.is_encoder_decoder:
        return cfg.replace(n_layers=layers,
                           n_enc_layers=min(layers, cfg.n_enc_layers))
    return cfg.replace(n_layers=layers)


def family_train_path(torch, cfg, params, batch, steps=TRAIN_STEPS,
                      device="cuda", key=None):
    """The JAX package's way to train a family whose inputs its data
    pipeline does not carry (frames, patches): ``step.make_train_step``
    on ``batch`` repeated, an AdamW state from ``optim.init_state``, at
    the ``Trainer``'s default learning rate and warm-up (phase 8's).
    Returns (the history as ``Trainer.run`` gives it, (flash, scan, scan
    backward) launches, peak device memory); with ``key``, notes in
    ``MEASURED[key]`` what phase 26 holds the dry run to."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.train import TrainerConfig, optim, step
    tcfg = TrainerConfig(steps=steps)
    ocfg = optim.AdamWConfig(lr=tcfg.lr)
    train = step.make_train_step(cfg, train_pcfg(), ocfg, optim.warmup_cosine(
        tcfg.lr, tcfg.warmup, steps))
    opt = optim.init_state(params, ocfg)
    on_card = device == "cuda"
    base = 0
    held = tree_nbytes({"p": params, "o": opt, "b": batch})
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    fkernel.launches = lkernel.launches = lkernel.backward_launches = 0
    hist, t = [], time.perf_counter()
    for i in range(steps):
        params, opt, metrics = train(params, opt, batch)
        rec = {k: float(v) for k, v in metrics.items()}
        hist.append({"step": i + 1, **rec, "wall_s": time.perf_counter() - t})
    launches = (fkernel.launches, lkernel.launches,
                lkernel.backward_launches)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if key:
        MEASURED[key] = step_held(
            launches, steps, held, peak - (base - held),
            np.diff([0.0] + [h["wall_s"] for h in hist]))
    return hist, launches, peak


def flash_backward_times(torch, label, captured, calls) -> float:
    """The flash Function's backward (the plain version recomputed row by
    row) on each captured training launch's q / k / v, with an upstream
    gradient from a fixed seed, times ``calls[route]`` a step.  Returns
    the milliseconds a step."""
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator().manual_seed(23)
    total, parts = 0.0, []
    for route, (qkv, kw) in captured.items():
        # copies outside inference mode: autograd recomputes on them
        q, k, v = (x.clone() for x in qkv)
        g = torch.randn(q.shape, generator=gen).to(q.dtype).to(q.device)
        ms = timed_ms(torch, lambda: ops.flash_attention_backward(
            q, k, v, g, causal=kw["causal"], window=kw["window"]),
            warmup=1, runs=5)
        total += ms * calls[route]
        parts.append(f"{route} q {list(q.shape)} k/v {list(k.shape)} "
                     f"causal={kw['causal']} window={kw['window']}: "
                     f"{ms:.4f} ms a call, {calls[route]} a step")
    print(f"{label}: flash_attention backward (plain recompute, row by "
          f"row): " + "; ".join(parts) + f": {total:.3f} ms a step")
    return total


def train_family_phase(torch, seed: int, arch: str, device="cuda"):
    """Phases 23-24: ``arch`` at its full width in bf16 from ``seed``
    (``llava-next-mistral-7b`` at ``TRAIN_LAYERS`` of its layers), on a
    fresh card, trained as the JAX package trains it
    (``family_train_path``) on ``family_batch``.  First
    ``flash_attention`` at each of one forward's training shapes (an
    encoder-decoder's encoder, decoder and cross launches) held and timed
    as in phase 11 (d), and its plain backward timed; (a) the kernel
    route's loss and gradients (``grad_check``) against
    ``plain_kernels()`` in float32 (``FAMILY_CHECK_DTYPE``), and against
    ``tile_p_attention()`` in bf16 at one pattern unit; then
    ``FAMILY_STEPS`` steps in bf16: (b) the loss falls, finite; (c)
    exactly twice a forward's launches a step (full remat); (d) the peak
    device memory below the card's.  Returns (the steps' flash launches,
    the flash timings by route)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.models import model
    label = f"train {arch}"
    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        print(f"{label}: the first {TRAIN_LAYERS[arch]} of its "
              f"{cfg.n_layers} layers, at full width")
        cfg = cfg.replace(n_layers=TRAIN_LAYERS[arch])
    batch = family_batch(torch, cfg, seed, seq=TRAIN_SEQ, device=device)
    print(f"{label}: batch " + ", ".join(
        f"{k} {list(v.shape)} {str(v.dtype)[6:]}" for k, v in batch.items()))
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               device)
    per_unit = sum(s in "AL" for s in cfg.block_pattern)
    n_dec = cfg.n_groups * per_unit
    launch = (fkernel, "flash_attention_fwd")
    if cfg.is_encoder_decoder:
        n_enc = cfg.n_enc_layers // cfg.pattern_len * per_unit
        hooks = {"encoder": (*launch, 0), "decoder": (*launch, n_enc),
                 "cross": (*launch, n_enc + 1)}
        calls = {"encoder": n_enc, "decoder": n_dec, "cross": n_dec}
    else:
        hooks, calls = {"attn": (*launch, 0)}, {"attn": n_dec}
    with spying(torch, hooks) as captured, torch.inference_mode():
        model.loss_fn(params, batch, cfg=cfg, pcfg=train_pcfg())
    with torch.inference_mode():
        flash = {route: path_flash_times(torch, f"{label} {route}",
                                         captured[route])
                 for route in hooks}
    flash_backward_times(torch, label, captured, calls)
    del captured
    checked = cfg.replace(param_dtype=FAMILY_CHECK_DTYPE,
                          compute_dtype=FAMILY_CHECK_DTYPE)
    grad_check(torch, checked, seed, family_batch(
        torch, checked, seed, seq=TRAIN_SEQ, device=device), device=device,
        label=f"{label} {FAMILY_CHECK_DTYPE}")
    torch.cuda.empty_cache()
    cut = family_depth(cfg, cfg.pattern_len)
    grad_check(torch, cut, seed, family_batch(
        torch, cut, seed, seq=TRAIN_SEQ, device=device), device=device,
        label=f"{label} bfloat16 at {cut.n_layers} layers",
        reference=tile_p_attention)
    torch.cuda.empty_cache()
    hist, launches, peak = family_train_path(torch, cfg, params, batch,
                                             steps=FAMILY_STEPS,
                                             device=device,
                                             key="train_" + arch)
    report_train(cfg, hist, launches, peak, seq=TRAIN_SEQ, label=label)
    check_train(cfg, hist, launches)
    if device == "cuda":
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"{label}: max_memory_allocated={peak} of the card's {total} "
              f"bytes")
        check(peak < total, f"{label}: peak {peak} bytes, the card {total}")
    return launches[0], flash


def one_ulp(torch, params, seed: int):
    """``params`` with every embedding entry moved by one float32 ulp
    (signs from ``seed``): what a float32 stack's outputs move under it is
    the spread its own rounding can give."""
    e = params["embed"]["w"]
    sign = torch.from_numpy(np.random.default_rng(seed).choice(
        [-1.0, 1.0], tuple(e.shape)).astype(np.float32)).to(e.device)
    return dict(params, embed={"w": e * (1 + 2.0 ** -23 * sign)})


def xlstm_card_grads(torch, cfg, seed: int, seq: int, device="cuda"):
    """The model's first pattern unit (8 layers: 7 mLSTM, 1 sLSTM) with
    its embedding and head, at full width in float32, on one row of
    ``seq`` tokens from ``family_batch``: one step's loss and every
    gradient (phase 8's knobs) on ``device``, on the CPU, and on the CPU
    with the embeddings one ulp off (``one_ulp``: the spread the CPU's
    own rounding can give).  Returns the three (loss, [(path, gradient
    in float64)]) and the unit's config."""
    from repro_torch.models import model
    from repro_torch.train import step
    from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=cfg.pattern_len)
    params = model.init_params(cfg32, torch.Generator().manual_seed(seed),
                               "cpu")
    batch = family_batch(torch, cfg32, seed, seq=seq, batch=1, device="cpu")
    out = []
    for dev, tree in ((device, params), ("cpu", params),
                      ("cpu", one_ulp(torch, params, seed))):
        p = tree_map(lambda a: a.to(dev), tree)
        b = {k: v.to(dev) for k, v in batch.items()}
        t = time.perf_counter()
        (loss, _), grads = step._value_and_grad_accum(p, b, cfg=cfg32,
                                                      pcfg=train_pcfg())
        out.append((float(loss), [(path, g.detach().cpu().double()) for
                                  path, g in tree_flatten_with_paths(grads)]))
        print(f"train {cfg.name}: device check at {seq} tokens, {dev}"
              f"{' one ulp off' if len(out) == 3 else ''}: loss "
              f"{out[-1][0]:.6f} in {time.perf_counter() - t:.2f}s")
        del p, b, grads
    return out, cfg32


def xlstm_card_check(torch, cfg, seed: int, device="cuda",
                     seq=XLSTM_CHECK_SEQ) -> None:
    """(25a): ``xlstm_card_grads`` on ``seq`` tokens: the loss and every
    gradient leaf on the card within ``XLSTM_GRAD_TOL`` (relative L2) of
    the CPU's, all finite; a leaf whose gradient is zero in exact
    arithmetic (``XLSTM_ZERO_LEAF``) instead below ``XLSTM_ZERO_TOL`` of
    its layer's ``b_f`` gradient in norm, on either device.  The CPU's
    one-ulp spread of each leaf is printed beside (the worst)."""
    (got, want, ulp), cfg32 = xlstm_card_grads(torch, cfg, seed, seq, device)
    d_loss = abs(got[0] - want[0]) / abs(want[0])
    worst, worst_leaf, worst_spread, spread_leaf = 0.0, "", 0.0, ""
    zeros = []
    g_all, w_all = dict(got[1]), dict(want[1])
    for (path, g), (_, w), (_, u) in zip(got[1], want[1], ulp[1]):
        check(bool(torch.isfinite(g).all()),
              f"{cfg.name}: the gradient of {path} on the card is not finite")
        if path.endswith(XLSTM_ZERO_LEAF):
            sibling = path.rsplit("/", 1)[0] + "/b_f"
            for name, tree in (("card", g_all), ("CPU", w_all)):
                ratio = float(tree[path].norm() / tree[sibling].norm())
                zeros.append(f"{path} {name} {ratio:.3e}")
                check(ratio <= XLSTM_ZERO_TOL,
                      f"{cfg.name}: the gradient of {path} on the {name}, "
                      f"{ratio} of {sibling}'s in norm, is not zero")
            continue
        norm = float(w.norm().clamp_min(1e-30))
        rel = float((g - w).norm()) / norm
        spread = float((u - w).norm()) / norm
        if rel > worst:
            worst, worst_leaf = rel, path
        if spread > worst_spread:
            worst_spread, spread_leaf = spread, path
        check(rel <= XLSTM_GRAD_TOL,
              f"{cfg.name}: the gradient of {path} on the card against the "
              f"CPU: relative L2 {rel} (the CPU's one-ulp spread {spread})")
    print(f"train {cfg.name}: device check ({cfg32.n_layers} layers, "
          f"d_model {cfg32.d_model}, float32, 1 x {seq} tokens) over "
          f"{len(want[1])} leaves: loss relative diff {d_loss:.3e}; worst "
          f"gradient relative L2 {worst:.3e} ({worst_leaf}); bar "
          f"{XLSTM_GRAD_TOL}; the CPU's worst one-ulp spread {worst_spread:.3e}"
          f" ({spread_leaf}); zero in exact arithmetic, in norm of b_f's: "
          + "; ".join(zeros) + f" (bar {XLSTM_ZERO_TOL})")
    check(d_loss <= XLSTM_GRAD_TOL, f"{cfg.name}: loss on the card "
          f"{got[0]} against the CPU's {want[0]}")


def xlstm_train_phase(torch, seed: int, device="cuda") -> None:
    """Phase 25: ``xlstm-1.3b`` in bf16 from ``seed`` at full width and
    ``XLSTM_TRAIN_LAYERS`` of its layers, on a fresh card: (a)
    ``xlstm_card_check``; then the ``Trainer`` on a one-batch corpus in
    Sector, as phase 8 trains (``train_path``), for ``XLSTM_TRAIN_STEPS``
    steps: the loss falls, finite, and no kernel launches (the family has
    none)."""
    from repro_torch.configs import get_config
    cfg = get_config(XLSTM_ARCH)
    print(f"train {XLSTM_ARCH}: the first {XLSTM_TRAIN_LAYERS} of its "
          f"{cfg.n_layers} layers, at full width")
    cfg = cfg.replace(n_layers=XLSTM_TRAIN_LAYERS)
    xlstm_card_check(torch, cfg, seed, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_xlstm_") as tmp:
        trainer, hist, launches, peak = train_path(
            torch, cfg, seed, Path(tmp), seq=TRAIN_SEQ, device=device,
            steps=XLSTM_TRAIN_STEPS)
        del trainer
    report_train(cfg, hist, launches, peak, seq=TRAIN_SEQ,
                 label=f"train {XLSTM_ARCH}")
    check_train(cfg, hist, launches)


# ------------------------------------------------------------ phase 26
# the steps the card ran that the dry run counts, by their MEASURED key:
# (arch, layers (0: all; a dict: the config's fields cut), kind, tokens a
# row, global rows, (data, model) of a stand-in mesh or None, knobs
# beside phase 8's, cache capacity)
PREFILL_ARCH = "qwen3-8b"       # phase 17's warm prefill
DRYRUN_STEPS = {
    "train": (LM_ARCH, 0, "train", TRAIN_SEQ, TRAIN_BATCH, None, {}, 0),
    "train_mesh": (LM_ARCH, MESH_LAYERS, "train", MESH_SEQ, TRAIN_BATCH,
                   (MESH_LM_RANKS, 1), {}, 0),
    "train_mesh_accum": (LM_ARCH, POD_LAYERS, "train", MESH_SEQ,
                         ACCUM_BATCH, (MESH_LM_RANKS, 1),
                         {"accum_steps": MESH_ACCUM}, 0),
    "train_mesh_tp": (LM_ARCH, POD_LAYERS, "train", MESH_SEQ,
                      TP_TRAIN_BATCH, TP_TRAIN_SHAPE, {"layout": "tp"}, 0),
    "train_mesh_tp5": (LM_ARCH, TP5_CUT, "train", MESH_SEQ, TP_TRAIN_BATCH,
                       TP5_SHAPE, {"layout": "tp"}, 0),
    **{"mesh_moe_" + run: (MOE_ARCH, MESH_MOE_LAYERS, "train", MESH_MOE_SEQ,
                           TRAIN_BATCH, shape,
                           {"layout": layout, "moe_dispatch": dispatch}, 0)
       for run, (shape, layout, dispatch) in MESH_MOE_RUNS.items()},
    "train_" + ENCDEC_ARCH: (ENCDEC_ARCH, 0, "train", TRAIN_SEQ, TRAIN_BATCH,
                             None, {}, 0),
    "train_" + VLM_ARCH: (VLM_ARCH, TRAIN_LAYERS[VLM_ARCH], "train",
                          TRAIN_SEQ, TRAIN_BATCH, None, {}, 0),
    "prefill_" + PREFILL_ARCH: (PREFILL_ARCH, 0, "prefill", LONG_PROMPTS[0],
                                1, None, {}, SERVE_LEN),
}
# every step's peak is held within this; a miss is a finding in the count,
# not a band to widen
DRYRUN_PEAK_REL = 0.15
# production cells the phase runs through the dry run's command line
DRYRUN_CELLS = (("recurrentgemma-2b", "train_4k", False),
                ("qwen3-8b", "decode_32k", True))
DRYRUN_WAIT_S = 300             # the counts start after phase 27
KERNEL_NAMES = ("flash_attention", "rg_lru_scan", "rg_lru_scan_backward")


def dryrun_counts(out: str) -> None:
    """Phase 26's counts, in a process of their own (:func:`start_dryrun`,
    beside the card's phases; the dry run needs no card): the dry run of
    each of ``DRYRUN_STEPS`` on one device or a stand-in mesh of its
    shape (``launch/dryrun.py``'s ``count_step``), then the dry run's
    command line on each of ``DRYRUN_CELLS``; all written to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_compat
    steps = {}
    for key, (arch, layers, kind, seq, rows, shape, knobs, cap) in \
            DRYRUN_STEPS.items():
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(**layers) if isinstance(layers, dict) \
                else cfg.replace(n_layers=layers)
        t = time.perf_counter()
        with dryrun.standin_group(math.prod(shape) if shape else 1):
            mesh = make_mesh_compat(shape, ("data", "model"),
                                    device="meta") if shape else None
            rec = dryrun.count_step(cfg, ShapeConfig(key, seq, rows, kind),
                                    mesh_lm_pcfg(mesh, **knobs), max_len=cap)
        rec["wall_s"] = time.perf_counter() - t
        steps[key] = rec
    cli = {}
    for arch, shape, multi_pod in DRYRUN_CELLS:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape] + (["--multi-pod"] if multi_pod else []),
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=600)
        cli[f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"] = {
            "rc": proc.returncode, "s": time.perf_counter() - t,
            "out": proc.stdout[-2000:] + proc.stderr[-2000:]}
    Path(out).write_text(json.dumps({"steps": steps, "cli": cli,
                                     "ended": time.time()}))


def start_dryrun(tmp: Path):
    """Start :func:`dryrun_counts` in a process of its own, the card
    hidden from it; it is killed if this script ends first.  Returns
    (the process, its result's path, its log's path, its start time)."""
    out, log = tmp / "dryrun.json", tmp / "dryrun.log"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(ROOT / "src")}
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, "
             f"{str(ROOT)!r}); import chip_smoke; "
             f"chip_smoke.dryrun_counts({str(out)!r})"],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, log, time.time()


def dryrun_phase(torch, worker, wall0: float) -> None:
    """Phase 26: each reused step's dry run (``MEASURED``) held to the
    card's: every kernel's launches a step and the arguments' bytes
    exactly, each mesh rank's bytes a step by collective
    (``sharded.WIRE``) exactly, the peak within ``DRYRUN_PEAK_REL``
    (a mesh step's without step 1's gradient check, whose peak is
    printed); the dry run's FLOPs over the step's median seconds
    at 989 TFLOP/s printed; the production cells' records ``ok``.
    ``wall0`` is the run's start (``time.time()``)."""
    proc, out, log, started = worker
    t = time.perf_counter()
    try:
        proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    waited = time.perf_counter() - t
    check(proc.returncode == 0 and out.exists(),
          f"the dry run's process exited with {proc.returncode}: "
          f"{log.read_text()[-3000:]}")
    got = json.loads(out.read_text())
    card = card_line()
    print(f"dryrun: counts ready {waited:.1f}s into phase 26, made from "
          f"{started - wall0:.1f}s to {got['ended'] - wall0:.1f}s of the "
          f"run; each step's dry run took (host seconds) " + ", ".join(
              f"{k} {r['wall_s']:.1f}" for k, r in got["steps"].items()))
    for key, rec in got["steps"].items():
        meas = MEASURED.get(key)
        check(meas is not None, f"phase 26: no step {key} was measured")
        launches = tuple(rec["kernels"].get(n, {}).get("launches", 0)
                         for n in KERNEL_NAMES)
        check(launches == tuple(meas["launches"]),
              f"dryrun {key}: launches {launches} (flash, scan, scan "
              f"backward), the card's a step {meas['launches']}")
        mem = rec["memory"]
        check(mem["argument_bytes"] == meas["argument_bytes"],
              f"dryrun {key}: argument_bytes {mem['argument_bytes']}, the "
              f"card's step held {meas['argument_bytes']}")
        rel = mem["peak_bytes"] / meas["peak"] - 1
        check(abs(rel) <= DRYRUN_PEAK_REL,
              f"dryrun {key}: peak_bytes {mem['peak_bytes']}, the card's "
              f"step {meas['peak']} ({rel:+.4f})")
        wire = rec["collectives"]["wire"]
        for r, rank_wire in enumerate(meas["wire"] or ()):
            check(all(wire[k] == v for k, v in rank_wire.items()),
                  f"dryrun {key}: bytes a step {wire}, the card's rank {r} "
                  f"{rank_wire}")
        share = rec["cost"]["flops"] / (meas["step_s"] * PEAK_BF16_PER_S)
        print(f"dryrun {key} ({card}): launches a step {launches} equal; "
              f"argument_bytes {mem['argument_bytes']} equal; peak_bytes "
              f"{mem['peak_bytes']} against max_memory_allocated "
              f"{meas['peak']} less what else the process held ({rel:+.4f}"
              f", held within {DRYRUN_PEAK_REL}"
              + ("" if meas.get("check_peak") is None else
                 f"; step 1's gradient check, kept out of the step's peak, "
                 f"reached {meas['check_peak']} "
                 f"({mem['peak_bytes'] / meas['check_peak'] - 1:+.4f})")
              + f"); flops {rec['cost']['flops']:.4e} over the median step "
              f"{meas['step_s']:.4f}s at 989 TFLOP/s bf16: {share:.4f} of "
              f"the peak; hbm bytes {rec['cost']['bytes accessed']:.4e}"
              + ("" if meas["wire"] is None else
                 f"; bytes a step by collective equal to each of the "
                 f"{len(meas['wire'])} ranks': "
                 + " ".join(f"{k} {v}" for k, v in meas["wire"][0].items())))
    for cell, run in got["cli"].items():
        path = ROOT / "experiments" / "dryrun_torch" / f"{cell}.json"
        check(run["rc"] == 0 and path.exists(),
              f"dryrun {cell}: the command exited with {run['rc']}: "
              f"{run['out']}")
        rec = json.loads(path.read_text())
        check(rec["ok"], f"dryrun {cell}: not ok: {rec.get('error')}")
        m, c = rec["memory"], rec["collectives"]
        print(f"dryrun {cell}: ok in {run['s']:.1f}s of host time; a "
              f"rank: flops {rec['cost']['flops']:.4e}, hbm bytes "
              f"{rec['cost']['bytes accessed']:.4e}, argument_bytes "
              f"{m['argument_bytes']}, peak_bytes {m['peak_bytes']}, "
              f"collective bytes {c['total']} (inside a node "
              f"{c['intra_node']}, across nodes {c['inter_node']}, across "
              f"pods {c['cross_pod']}), roofline "
              f"{rec['roofline']['bound_s']:.4e}s "
              f"({rec['roofline']['bound_by']}; H100 SXM data sheet)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=10_000_000)
    ap.add_argument("--points", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    # the plain versions run in full float32 (no TF32 matrix products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # phase 1: set-up
    t0, wall0 = time.perf_counter(), time.time()
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    build_all(ROOT / "build" / "repro_torch")

    # phases 14-15: the LM training mesh, 2 gloo ranks sharing the card,
    # run first, while this process holds nothing on the card: two ranks
    # of the full model need all but a few GiB of it, and after phases
    # 2-13 this process kept enough cached there that a rank ran out
    t = fresh_card(torch, 14)
    mesh_launches, accum_launches = mesh_lm_phase(torch, args.seed)
    print(f"phases 14-15 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # (14c): tensor-parallel training, 2 ranks at (data, model) = (1, 2)
    t = fresh_card(torch, "14c")
    tp_launches = tp_train_phase(torch, args.seed)
    print(f"run 14c done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phase 21: the MoE on the LM training mesh, on a card holding nothing
    # of phases 14-15
    t = fresh_card(torch, 21)
    moe_mesh_launches, moe_mesh_flash = moe_mesh_phase(torch, args.seed)
    print(f"phase 21 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phase 22: serving on the mesh, 2 ranks at (data, model) = (1, 2)
    t = fresh_card(torch, 22)
    serve_mesh = serve_mesh_phase(torch, args.seed)
    print(f"phase 22 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phase 27: the MoE, encoder-decoder and xLSTM families on the
    # serving mesh, 2 ranks at (data, model) = (1, 2)
    t = fresh_card(torch, 27)
    serve_families = serve_mesh_phase(torch, args.seed, cfgs=family_cfgs(),
                                      phase=27)
    print(f"phase 27 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phase 28: tensor-parallel training and serving on 5 ranks at
    # (data, model) = (1, 5), the RG-LRU's slices crossing its gate blocks
    t = fresh_card(torch, 28)
    tp5 = tp5_phase(torch, args.seed)
    print(f"phase 28 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phase 26's counts run on the host beside phases 2-25, after the
    # host-staged mesh phases 14-22, 27 and 28, whose seconds they would
    # slow
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    atexit.register(shutil.rmtree, work, True)
    worker = start_dryrun(work)

    # phase 2: every kernel against its plain version on the card
    rows = {r["name"]: r for r in (dest_phase(torch), *partition_phase(torch),
                                   *assign_phase(torch))}
    print(f"kernels checked at {time.perf_counter() - t0:.1f}s")

    # phases 3-5: the paths, each counting only its own launches
    launches, rep, outs, data, order, bounds, tera_wall, _ = terasort_path(
        torch, args.records, args.seed)
    want = check_terasort(launches["bucket_dest"], rep, outs, data, order)
    rows["bucket_dest"]["launches"] = launches["bucket_dest"]
    tera = {"wall_s": tera_wall, "report": sim_fields(rep),
            "round_s": rep.partition_seconds}
    del order, rep
    p_launches, calls, ids, hist, sorted_bytes = partition_path(torch, data,
                                                                bounds)
    check_partition(p_launches, calls, ids, hist, sorted_bytes, data, bounds,
                    outs, want)
    rows["bucket_partition_rows"]["launches"], \
        rows["bucket_partition"]["launches"] = p_launches
    del data, outs, want, ids, sorted_bytes
    print(f"terasort and partition paths done at "
          f"{time.perf_counter() - t0:.1f}s")
    k_launches, n_chunks, cents, k_rep, pts = kmeans_path(
        torch, args.points, args.seed)
    check_kmeans(torch, k_launches, n_chunks, cents, k_rep, pts, args.seed)
    rows["kmeans_partials"]["launches"], rows["kmeans_assign"]["launches"] \
        = k_launches
    del cents, k_rep, pts
    torch.cuda.empty_cache()
    print(f"k-means path done at {time.perf_counter() - t0:.1f}s")

    # phase 6: the LM kernels on the full model's activations
    cfg, params = lm_model(torch, args.seed)
    prompts = serve_prompts(cfg, args.seed)
    captured = capture_activations(torch, cfg, params, prompts[0])
    with torch.inference_mode():
        rows["flash_attention"] = flash_phase(torch, captured)
        rows["rg_lru_scan"] = lru_phase(torch, captured)
    scan_inputs = {"scan": captured["scan"]}     # phase 8's (b)
    del captured
    torch.cuda.empty_cache()
    print(f"LM kernels checked at {time.perf_counter() - t0:.1f}s")

    # phase 7: serving
    eng, reqs, steps, lm_launches, last_logits, peak = serve_path(
        torch, cfg, params, prompts)
    check_serve(cfg, eng, reqs, steps, lm_launches)
    steady_s = report_serve(reqs, steps, lm_launches, peak)
    check_logits(torch, cfg, params, prompts, last_logits)
    profile_decode(torch, eng, steady_s)
    profile_prefill(torch, cfg, params, prompts[0])
    # the serving tensors were made for inference: training builds its own
    del eng, reqs, steps, last_logits, params
    torch.cuda.empty_cache()
    print(f"serving done at {time.perf_counter() - t0:.1f}s")

    # phase 8: training
    from repro_torch.data.dataset import Cursor
    rows["rg_lru_scan_backward"] = scan_backward_phase(torch, scan_inputs)
    del scan_inputs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        _, ds, _ = train_data(torch, tmp / "grad", cfg, args.seed)
        host, _ = next(ds.batches(TRAIN_BATCH, Cursor()))
        grad_check(torch, cfg, args.seed,
                   {k: torch.from_numpy(v).cuda() for k, v in host.items()})
        torch.cuda.empty_cache()
        time_flash_backward(torch, cfg)
        trainer, hist, t_launches, t_peak = train_path(torch, cfg, args.seed,
                                                       tmp / "train",
                                                       key="train")
        check_train(cfg, hist, t_launches)
        step_s = report_train(cfg, hist, t_launches, t_peak)
        profile_train_step(torch, trainer, step_s)
        time_adamw(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
        resume_check(torch, cfg, args.seed, tmp / "resume")
    print(f"training done at {time.perf_counter() - t0:.1f}s")

    # phase 9: the mesh data plane, world 1 over NCCL, then 3 and 4 ranks
    # sharing the card over gloo
    m_launches = mesh_world1(torch, args.records, args.seed, tera)
    rank_launches = mesh_ranks(args.seed, min(args.records, MESH_RECORDS))
    print(f"mesh done at {time.perf_counter() - t0:.1f}s")

    # phases 10-11: the xLSTM and MoE families served at full width, each
    # on a card holding nothing of the earlier phases
    t = fresh_card(torch, 10)
    xlstm_phase(torch, args.seed)
    print(f"phase 10 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")
    t = fresh_card(torch, 11)
    moe_launches, rows["flash_attention"][MOE_ARCH] = moe_phase(torch,
                                                                args.seed)
    rows["flash_attention"]["train_" + MOE_ARCH] = moe_mesh_flash
    for arch, (_, timings) in {**serve_mesh, **serve_families}.items():
        for route, timing in timings["flash"].items():
            rows["flash_attention"]["serve_mesh_" + arch + (
                "" if route == "self" else "_" + route)] = timing
        if "scan_prefill" in timings:
            rows["rg_lru_scan"]["serve_mesh_prefill"] = \
                timings["scan_prefill"]
            rows["rg_lru_scan"]["serve_mesh_decode"] = timings["scan_decode"]
    rows["flash_attention"]["serve_mesh_tp5_" + LM_ARCH] = \
        tp5["timings"]["flash"]["self"]
    rows["rg_lru_scan"]["serve_mesh_tp5_prefill"] = \
        tp5["timings"]["scan_prefill"]
    rows["rg_lru_scan"]["serve_mesh_tp5_decode"] = \
        tp5["timings"]["scan_decode"]
    print(f"phase 11 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phases 12-13: the encoder-decoder and the vision backbone served at
    # full width, each on a card holding nothing of the earlier phases
    t = fresh_card(torch, 12)
    encdec_launches, rows["flash_attention"][ENCDEC_ARCH] = encdec_phase(
        torch, args.seed)
    print(f"phase 12 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")
    t = fresh_card(torch, 13)
    vlm_launches, image_launches, rows["flash_attention"][VLM_ARCH] = \
        vlm_phase(torch, args.seed)
    print(f"phase 13 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phases 16-20: the four configs held last and qwen2.5-3b, served at
    # full width (dbrx-132b at 8 of its 40 layers), each on a fresh card
    held_launches = {}
    for phase, arch in enumerate(HELD_ARCHS, 16):
        t = fresh_card(torch, phase)
        held_launches[arch], rows["flash_attention"][arch] = held_phase(
            torch, args.seed, arch)
        print(f"phase {phase} done in {time.perf_counter() - t:.1f}s (at "
              f"{time.perf_counter() - t0:.1f}s)")

    # phases 23-25: seamless-m4t-large-v2 and llava-next-mistral-7b (12 of
    # its 32 layers) trained through make_train_step, xlstm-1.3b through
    # the Trainer, at full width, each on a fresh card
    train_launches = {}
    for phase, arch in ((23, ENCDEC_ARCH), (24, VLM_ARCH)):
        t = fresh_card(torch, phase)
        train_launches["train_" + arch], \
            rows["flash_attention"]["train_" + arch] = train_family_phase(
                torch, args.seed, arch)
        print(f"phase {phase} done in {time.perf_counter() - t:.1f}s (at "
              f"{time.perf_counter() - t0:.1f}s)")
    t = fresh_card(torch, 25)
    xlstm_train_phase(torch, args.seed)
    print(f"phase 25 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    # phase 26: the dry run of the steps above held to the card's
    t = time.perf_counter()
    dryrun_phase(torch, worker, wall0)
    print(f"phase 26 done in {time.perf_counter() - t:.1f}s (at "
          f"{time.perf_counter() - t0:.1f}s)")

    for name, by_path in (
            ("bucket_dest", {
                "terasort": launches["bucket_dest"],
                **{f"mesh_ranks_{w}": n["bucket_dest"]
                   for w, n in rank_launches.items()}}),
            ("bucket_partition_rows", {
                "partition": p_launches[0],
                "mesh": m_launches["bucket_partition_rows"],
                **{f"mesh_ranks_{w}": n["bucket_partition_rows"]
                   for w, n in rank_launches.items()}}),
            ("kmeans_partials", {
                "kmeans": k_launches[0],
                **{f"mesh_ranks_{w}": n["kmeans_partials"]
                   for w, n in rank_launches.items()}}),
            ("flash_attention", {"serve": lm_launches[0],
                                 "train": t_launches[0],
                                 "train_mesh": sum(x[0] for x in
                                                   mesh_launches),
                                 "train_mesh_accum": sum(
                                     x[0] for x in accum_launches),
                                 **moe_mesh_launches,
                                 "serve_" + MOE_ARCH: moe_launches[0],
                                 "serve_" + ENCDEC_ARCH: encdec_launches[0],
                                 "serve_" + VLM_ARCH: vlm_launches[0],
                                 "image_" + VLM_ARCH: image_launches,
                                 **{"serve_" + arch: n[0] for arch, n in
                                    held_launches.items()},
                                 "train_mesh_tp": sum(x[0] for x in
                                                      tp_launches),
                                 **{"serve_mesh_" + arch: sum(
                                     x[0] for x in n) for arch, (n, _) in
                                    {**serve_mesh,
                                     **serve_families}.items()},
                                 "train_mesh_tp5": sum(
                                     x[0] for x in tp5["train"]),
                                 "serve_mesh_tp5": sum(
                                     x[0] for x in tp5["serve"]),
                                 **train_launches}),
            ("rg_lru_scan", {"serve": lm_launches[1],
                             "train": t_launches[1],
                             "train_mesh": sum(x[1] for x in mesh_launches),
                             "train_mesh_accum": sum(
                                 x[1] for x in accum_launches),
                             "train_mesh_tp": sum(x[1] for x in tp_launches),
                             "serve_mesh_" + LM_ARCH: sum(
                                 x[1] for x in serve_mesh[LM_ARCH][0]),
                             "train_mesh_tp5": sum(
                                 x[1] for x in tp5["train"]),
                             "serve_mesh_tp5": sum(
                                 x[1] for x in tp5["serve"])}),
            ("rg_lru_scan_backward", {"train": t_launches[2],
                                      "train_mesh": sum(
                                          x[2] for x in mesh_launches),
                                      "train_mesh_accum": sum(
                                          x[2] for x in accum_launches),
                                      "train_mesh_tp": sum(
                                          x[2] for x in tp_launches),
                                      "train_mesh_tp5": sum(
                                          x[2] for x in tp5["train"])})):
        rows[name]["launches"] = sum(by_path.values())
        rows[name]["launches_by_path"] = by_path
    # the k-means path runs the fused entry and the partition path the
    # rows entry; the ids and words entries, held and timed in phase 2,
    # are on no path
    for r in rows.values():
        check(r["launches"] > 0
              or r["name"] in ("kmeans_assign", "bucket_partition"),
              f"its path never launched {r['name']}")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s "
          f"on {card_line()}")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
