#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:

1. card     — ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build    — compiles every kernel of ``spacy_ray_tpu_torch/csrc`` with
              nvcc for sm_90a (one nvcc per source, in parallel), with each
              kernel's registers and spills (``ptxas -v``).
3. kernel:* — each kernel's wrapper on the card at the shapes its path
              gives it (the serving slice's for K1, K2, K4, and K1 also for
              one one-text request and a training microbatch; a training
              microbatch's and the whole parameter set's for the hash-embed
              gradient, the attention backward K3 and the fused update K5),
              held against its plain PyTorch version on the same inputs
              (tolerances below), and timed with CUDA events beside its
              plain version, a PyTorch library call computing the same
              function where one exists, and its bound; ``host_us`` is the
              host's time to launch it through its wrapper. K4 runs with
              bf16 x (the serving path's input; bytes bound at 2 bytes per
              element) and with f32 x; its library call is cuBLAS f32 on
              the dequantized weight, with cuBLAS bf16 beside it; the table
              gradient reports its device operations per call by name and
              time (``torch.profiler``) and is rerun bit-identical.
4. slice:*  — the transformer + tagger pipeline at the width of
              ``configs/trf.cfg`` (768 wide, 12 layers, 12 heads, FFN 3072,
              embed 20000; random weights from a seed), saved with
              ``to_disk`` and served through the ``serve`` entry point on
              port 0 (``--max-batch 8 --max-doc-len 128``), once with
              ``--precision auto`` (bf16) and once with ``--precision int8``.
              Launch counters are zeroed just before the requests and read
              just after; the trunk output of one batch is held against the
              same pipeline with every kernel swapped for its plain version,
              and one forward at the top bucket (B=8, T=128) is timed both
              ways.
5. cli      — ``python -m spacy_ray_tpu_torch serve`` as a subprocess
              answers one request (beside train:fleet_elastic's start).
6. train:trf — ``train()`` of the port on the card, on a config whose
              transformer and tagger blocks and ``[training]`` block are
              ``configs/trf.cfg``'s (``max_steps`` 40, ``eval_frequency``
              20; the trunk at depth ``TRF_CUT_DEPTH``, full width), over a synthetic corpus written here (2000 train and 200
              dev docs of 8-120 words whose tags follow from the words).
              Launch counters are zeroed just before and read just after;
              every training kernel must have launched and the loss must
              fall. Then one step is split into forward, backward and
              optimizer (device and host-enqueue time), the gradients of one
              microbatch with every kernel are held against the same
              microbatch with every kernel swapped for its plain version
              (dropout off), and ``best-model/`` answers one request through
              the serving path.
7. train:full — ``train()`` on ``configs/trf.cfg`` as written (tagger,
              parser and NER heads, its score weights), ``max_steps`` 40 and
              ``eval_frequency`` 20, on a pseudo-UD corpus written here
              (``udgen``: 2000 train and 200 dev docs, seeds 0 and 1). The
              five training kernels must launch and each head's loss must
              fall to at most 2/3 of its start (means of the first and last
              5 steps); one microbatch's forward + backward is timed with
              every head and with the tagger alone (events, host clock,
              and kernel time and device operations under the
              profiler), and its gradients of
              every leaf, the heads' included, are held against the plain
              versions (dropout off). With telemetry on
              (``metrics_dir``, a ``metrics_port`` scraped every second
              for ``/metrics`` as JSON and Prometheus text and ``/healthz``,
              ``trace_steps`` [5, 15]): one ``step`` row a step and one
              ``eval`` row an evaluation, step spans for steps 6-15 only,
              each eval row's ``hbm_peak_bytes`` in (0, the run's peak], ``mfu``
              in (0, 1), no anomaly, and ``telemetry collect-trace``'s merge
              of the trainer's endpoint holding its spans on the trainer's
              track; ``flops_per_step`` beside the trunk's and tagger's
              analytic count, telemetry's ``step_seconds_p50`` beside the
              events' median. The same run again with telemetry off must
              end with every parameter and step loss bit-equal; its events'
              median beside the first run's is telemetry's cost a step.
8. slice:full — ``train:full``'s ``last-model/`` served at ``--precision
              auto`` with slice:auto's traffic over the dev texts: every doc
              answered with tags, heads and deps, the heads' decodes
              replayed as CUDA graphs. For one B 8, T 128 batch: the graph
              replay bit-equal to the eager decode of the same trunk output,
              the card's decode against a CPU decode (>= 0.99 agreement),
              the kernels against their plain versions (heads >= 0.95,
              entity sets F >= 0.95), and the decodes' device and enqueue
              times and device operations, as replays and eagerly.

9. kernel:* at the CNN's shapes (after the training kernels) — K1 fwd
              and K1 bwd at D 96 over the 2000- and 1000-row tables of
              configs/cnn.cfg, at ``train:cnn``'s first microbatch (the
              corpus's ids) and at one request (N 128), bit-equal to the
              plain versions; K5 over cnn.cfg's and sm.cfg's leaves under
              three hyper sets at 0 ulp; each with kernel, plain, library and
              bound ms and the timer's floor.
10. train:cnn — ``train()`` on configs/cnn.cfg as written (HashEmbedCNN
              width 96, depth 4, embed_size 2000; tagger), ``max_steps`` 60
              and ``eval_frequency`` 20, on the pseudo-UD corpus written as
              ``.spacy`` files by the port's writer. K1 fwd, K1 bwd and K5
              must launch and the loss fall to <= 2/3; reports step time
              (events and host clock), words/s, peak memory, dev scores, the
              card's idle share over 5 profiled steps with the top kernels,
              the device operations of a microbatch with the hash ids'
              share, the host's collate time, and the gradients of every
              leaf against the plain versions.
11. slice:cnn — ``train:cnn``'s ``best-model/`` served at ``--precision
              auto`` (f32: the overlay needs a transformer trunk) with
              slice:auto's request pattern over dev texts; the card's tags
              against the same model on the CPU (>= 0.99 of tokens).
12. train:sm, slice:sm — configs/sm.cfg as written (tagger, parser and NER
              over the same CNN) the same way: every head's loss falls to
              <= 2/3, dev tag_acc, dep_las and ents_f, the oracle's
              doc-passes; served with its decodes as CUDA graphs captured at
              width 96, graph replay bit-equal to the eager decode, card vs
              CPU decode >= 0.99, and the served answers against the CPU's.
13. cli:cnn — ``python -m spacy_ray_tpu_torch train configs/cnn.cfg`` on
              the .spacy corpus and ``evaluate`` on its best-model, as
              subprocesses on the card: the trainer of serve:watch (22.),
              40 steps, its line emitted there. Its seconds are the train
              command's and the evaluate command's, each from its start to
              its end, both beside serve:watch's server and serve:fleet's
              booting replicas.
14. train:spancat, slice:spancat — configs/spancat.cfg as written
              (tok2vec, spancat with ngram sizes 1-3 and hidden 128,
              textcat_multilabel) the same way, on 1000 span docs and 1000
              cat docs in turn (100 + 100 dev; the port's generators,
              written as .spacy): each head's loss falls to <= 2/3, dev
              ``spans_sc_f`` >= 0.5 and ``cats_micro_f`` >= 0.7 at the last
              evaluation; served, every doc with ``spans["sc"]`` and every
              cat, card vs CPU span sets' F and docs' top cat >= 0.99.
15. train:textcat, slice:textcat — spaCy's default ``textcat``
              (TextCatEnsemble.v2: cnn.cfg's tok2vec inline, TextCatBOW.v3 of
              262144 rows) with cnn.cfg's [training] on 2000 cat docs (200
              dev): dev ``cats_score`` >= 0.7; served and compared alike.
16. train:tokcls, slice:tokcls — cnn.cfg with the morphologizer, senter
              and trainable lemmatizer beside its tagger, on the pseudo-UD
              .spacy corpus: every head's loss falls, dev tag/pos/morph/lemma
              accuracy and ``sents_f``; served, card vs CPU >= 0.99 on every
              token field. The kernel rows of 9. also hold K1 fwd/bwd at
              ``train:spancat``'s microbatch (B 512, T 32) and K5 over these
              three leaf sets (the BOW table's gradient zero but on 1 % of
              its rows).
17. md:assets, train:md, slice:md, slice:md_jax — spaCy's md layout
              (``md_config``: MultiHashEmbed.v2 rows 5000/1000/2500/2500
              with static vectors, tagger, parser, attribute ruler, rule
              lemmatizer, a NER with its own trunk, entity ruler) on the
              pseudo-UD .spacy corpus, over 20,000 x 300 vectors made from a
              seed and converted by the port's ``init-vectors``: K1 fwd/bwd
              at its tables and K5 over its trainable leaves (the kernel rows
              of 9.); trained the same way, dev ``tag_acc`` >= 0.9,
              ``dep_las`` >= 0.8, ``ents_f`` >= 0.8 and ``lemma_acc`` within
              1 % of the rule lemmatizer's score from gold POS, both frozen
              tables bit-equal to the vectors after training and out of K5's
              leaves and the opt state, a checkpoint's save time; served
              with the rule components' host ms and card vs CPU >= 0.99 on
              tags, POS, lemmas, heads, deps and entities; then the JAX-
              written ``tests/data/jax_md/`` served as slice:cnn serves.
18. nel:assets, train:nel, slice:nel, slice:nel_jax — (nel:assets,
              the linker's kernel rows and train:nel inside serve:fleet,
              while its replicas idle before the rollout) an entity linker
              added to train:md's best-model as spaCy's ``nel_emerson``
              tutorial adds one to a shipped pipeline (``nel_config``: every
              md component sourced and frozen, the NER annotating, the
              linker over its own HashEmbedCNN of width 96, depth 2), on a KB
              and corpora made from a seed over the same .spacy corpus
              (``nel_assets``: 120 aliases, 4-8 candidates each, independent
              64-wide normal vectors, the gold candidate decided by the
              mention's left context). K1 fwd/bwd at the linker's tables and
              K5 over the leaf set (the frozen leaves with zero gradients) in
              the kernel rows; trained the same way: frozen parameters and
              tables bit-equal to the source, the source's own ``ents_f``,
              ``tag_acc`` and ``dep_las``, dev ``nel_micro_f`` >= the
              prior-only decode + 0.3 (the 0.85 floor reported, held in
              train:nel_shared), ``before_update`` once a step in order, K1
              bwd for the linker's 4 tables only, the linker's gradients vs
              plain; served with the linker's host ms a dispatch, every
              alias-matching entity linked, card vs CPU >= 0.99 with kb_ids;
              then the JAX-written ``tests/data/jax_nel/`` served, its kb_ids
              equal to the JAX package's answers.
19. train:nel_shared — the same layout, seed and corpora over a KB whose
              vectors share a direction per candidate number
              (``nel_assets(shared=True)``): dev ``nel_micro_f`` >= 0.85 and
              >= the prior-only decode + 0.3 at step 60, beside train:nel's.
20. pretrain:chars, pretrain:vectors, train:cnn_pretrained, train:trf_init
              — a trunk started from weights. K5 rows over the two
              pretraining leaf sets (trunk + head) in the kernel rows of 9.;
              ``python -m spacy_ray_tpu_torch pretrain`` of configs/cnn.cfg's
              trunk over udgen's 2000 training docs as raw text
              (``spacy.JsonlCorpus.v1``): the characters objective (4
              characters, hidden 300, batch 64, Adam.v1 0.001, 200 steps; the
              loss of the last 5 steps <= 2/3 of the first 5, ``char_acc``
              rising, ``model-last.npz`` the trunk's key set and shapes, one
              batch's gradients vs plain within 1e-4 x max |g| beside the
              table-row control) and the vectors objective over md:assets'
              20,000 x 300 vectors (cosine, 60 steps; the loss <= 2/3, the
              targets only on tokens with a vector); ``python -m
              spacy_ray_tpu_torch train`` of cnn.cfg with ``--code`` (a
              callback and a logger), ``--initialize.init_tok2vec`` at
              pretrain:chars' file and a ``spacy.orth_variants.v1`` augmenter:
              the trunk at step 0 bit-equal to the file, ``before_update`` for
              steps 0-59 in order, dev ``tag_acc`` >= 0.9, the collate ms of a
              microbatch uncached, cached and as the augmented epoch yields
              it; ``train()`` of trf.cfg's trunk + tagger (depth
              ``TRF_CUT_DEPTH``) with ``init_weights`` at a RoBERTa-base-layout
              ``.safetensors`` made from a seed: every encoder leaf and
              ``pos``'s 512 rows bit-equal to the remap at step 0, the loss
              falling over 20 steps, K1, K2, K3 and K5 launched.
21. train:moe, slice:moe, serve:swap, serve:telemetry, slice:moe_jax — a
              switch-MoE trunk. K5 over its 177 leaves (531 M parameters;
              the expert leaves [8, 768, 3072]) in the kernel rows of 3.;
              ``python -m spacy_ray_tpu_torch train configs/trf.cfg
              --components.transformer.model.n_experts 8`` at full width on
              the udgen corpus (its [training] with max_steps 30,
              eval_frequency 15 and batches of 330 words: microbatches of
              B 16): K1 fwd/bwd, K2, K3, K5 launched, every head's loss
              falling, two checkpoint generations, ``loss_aux`` against
              ``router_aux_weight`` x the layers' aux from a recompute, the
              real tokens dropped at capacity per layer, one step's device
              time by part (attention, expert ``bmm``, dispatch and combine,
              router, K5) and every leaf's gradient against the plain
              versions with the routing of the kernels' run replayed;
              ``best-model`` served (``--max-batch 4 --max-doc-len 64``): at
              bf16 under 20 one-text requests a second, open loop, for 4 s
              (p50, p99), its ``/metrics`` keys and counters, Prometheus
              text, ``/trace`` spans, the same load with ``--no-telemetry``;
              on the same server ``/admin/swap`` to each generation under a
              steady stream, every response bit-equal to its generation's
              fresh engine (own decode graphs), ``/admin/rollback`` the first
              generation's bytes, 403 outside ``--swap-dir``, 409 for a torn
              generation; f32 answers against the CPU's at the same buckets;
              ``--precision int8`` refused with the JAX package's label; the
              JAX-written ``tests/data/jax_moe/`` answering as JAX did.
22. serve:multimodel, serve:watch (after slice:md) — several pipelines in
              one ``serve --model-manifest`` process: train:full's trf.cfg
              model (the default, pinned), train:md's and train:cnn's,
              ``--resident-models 2``, SLO classes gold (weight 4) and batch
              (1), tenants acme, bulk and metered (5 docs/s, burst 10),
              ``--max-batch 8 --max-doc-len 64``. 16 closed-loop clients per
              trf tenant keep both classes queued while cnn and md bursts
              alternate (5 loads, 2 of them md's, 4 evictions under trf's
              load), the metered tenant sends 4 x its quota, an
              unknown model, ETag repeats and an ``/admin/swap`` of md
              alone: no failed request, answers vs the CPU (trf >= 0.95
              bf16, md and cnn >= 0.99), a reload's captures while a trf
              batch was in flight, trf's gold:batch docs within 3.2-4.8,
              429s and the quota held, 404, every repeat 304 undispatched,
              md's ETags changed by its swap and trf's not, memory after the
              2nd and last eviction within 64 MB and each eviction giving
              back >= 90 % of its parameters and overlay, K1 fwd (trf: and
              K2) in each model's sequential probe; each load's from_disk,
              warmup and capture s, each eviction's drain s, p50/p99 by
              model and class, trf's during and outside reloads. Then cnn
              alone at ``--batching window --max-wait-ms 5`` and continuous
              under one open loop: the same answers, occupancy and p50/p99.
              serve:watch: ``serve <cnn> --watch <out>/last-model`` beside
              ``train configs/cnn.cfg`` (40 steps, a generation every 10) as
              subprocesses on the card, 4 clients of 2-text requests, then a
              torn higher generation: the trainer exits 0, at least two
              flips, no client's generation going back, the torn stamp never
              served and logged once, every batch bit-equal to its replay on
              a fresh engine of its generation; each flip's delay from its
              meta file, stage and flip s. The trainer starts beside the
              server's warmup, and serve:fleet's three processes boot
              beside both (two replicas warm and capture on the same card),
              so its flips and step times are read under that load.

23. train:fleet (after slice:cnn), train:fleet_async (beside the host's
              own work before the training kernels' rows: trf.cfg's and its
              MoE's leaf shapes, the head corpora, md:assets, the CNN
              configs' setup) — the trainer fleet:
              ``python -m spacy_ray_tpu_torch train configs/cnn.cfg
              --fleet-workers 2`` on train:cnn's .spacy corpora as a
              subprocess, two worker processes sharing the card, a free
              ``--fleet-base-port``. train:fleet: ``--quorum 2
              --max-staleness 0`` (lockstep), 40 steps evaluated every 20:
              exit 0, version 40 on both workers, nothing discarded, failed
              or timed out, applied + discarded = received, K1 fwd, K1 bwd
              and K5 launched in each worker (its ledger), the lead's loss
              falling, dev tag_acc >= 0.9, best-model/ served with tags
              equal to the CPU's on the same directory; printed: wall s,
              each worker's per-phase medians (data, pull, grad, push,
              apply_wait), wire bytes a step, peak memory, words/s beside
              train:cnn's. Its final generation (step 40) holds
              opt_state-40.part0of2.npz and part1of2, each digest-verified,
              assembling with no hole; ``train(resume=True)`` continues it
              in this process on the card for 5 steps (train:fleet:resume):
              it starts at step 40 with the parts' count, launches K1 fwd,
              K1 bwd and K5 (once a step) and ends with a generation at 45
              whose count is 5 more. train:fleet_async, the restart drill:
              JAX's defaults (quorum auto = 1, S 1), ``--max-restarts 1``,
              300 steps with a generation every 10 (evaluated on the first
              16 dev docs); worker 1's process is SIGKILLed once a
              generation is committed and its version is >= 10; its
              supervisor starts it again with ``--resume``: exit 0, one
              supervisor-restart, the victim's fleet-resume at a committed
              step and its version, its new owner row ``opt_source``
              "checkpoint" at that version launching K5 once per apply,
              applied + discarded <= received on both workers, the victim's
              loss falling after the rejoin, int8 pushes <= 0.30; printed:
              the seconds from the kill to the victim's first accepted push,
              its resumed step and version. The wire: train:fleet passes
              ``--grad-compression f32 --param-delta-window 0`` (the f32
              anchor), train:fleet_async ``--grad-compression int8
              --param-delta-window 4``; each fails unless every worker
              resolved that codec and window, its pushes weigh 1.0 of their
              f32 frames (f32, exactly) or at most 0.30 (int8), and its pulls
              1.0 (f32) or below 1.0 (some delta frames served); printed: the
              codec and its reason from each worker's ``fleet-wire-codec``
              event, push and pull bytes a step, each ratio to its
              ``_uncompressed`` counter, the push and pull phase medians.
              The kernel rows of 9. hold K5
              over each owner's slices of cnn.cfg (``OwnershipLayout`` at
              N 2 and N 3, contiguous copies, the clip link off) at
              ``MAXULP_K5``.

24. train:fleet_elastic (after slice:int8, with the serve CLI of 5.
              coming up beside it) — the fleet losing a worker:
              ``train configs/cnn.cfg --fleet-workers 3 --peer-lease-s 2``
              (quorum auto = 2, S 1), 160 steps evaluated every 40; worker
              2's process SIGKILLed once every worker's /metrics shows
              version >= 10 and the generation of step 40 is committed: exit
              0 with fleet-degraded-success, the evict
              row within 2 + 3 x 2 s + a step of the kill, both survivors
              at epoch 1, active [0, 1], quorum 1, each one's epoch-1 owner
              on the N 2 layout's slices (the K5 rows' shapes) launching K5
              once per apply, its moments carved from the generation of step
              40 (``opt_source`` "checkpoint"), applied + discarded <=
              received, the final
              generation's extra.fleet at epoch 1 and active [0, 1], dev
              tag_acc >= 0.95, the final model's tags on the card equal to
              the CPU's for >= 0.99 of the dev tokens; printed per survivor:
              epoch, active, quorum, evictions, shards_adopted,
              epoch_fenced, pull_failed, push_failed, the phases' median ms
              before the kill, between it and the re-shard and after, the
              seconds from the kill to the evict and apply rows, the losses
              of the 5 steps after the re-shard. It runs the
              wire's defaults, which resolve to bf16 pushes and a delta
              window of 4 on the card: pushes at most 0.55 of their f32
              frames, pulls below 1.0, printed as for 23.

25. serve:fleet (after serve:watch) — the serving fleet: ``python -m
              spacy_ray_tpu_torch serve-fleet <train:cnn's best-model>
              --replicas 2 --port 0`` as a subprocess, two replica processes
              on the card behind the router, started beside serve:watch's
              server and trainer (it takes 20-30 s to come up, most of it
              importing torch in three processes); this process draws the
              bodies and annotates their texts with the same model on the
              CPU. 4 clients send 300 requests of 1-8 dev texts through the
              router, 30 % repeating an answered body; replica 0 (its pid from
              the router's roster) is SIGKILLed at the half. Then 100 fresh
              bodies one at a time through the router and straight to replica
              1 in turns, while replica 0 restarts. Fails unless no request
              failed, replica 0 is back in rotation
              within 60 s (the supervisor's restart), every cache hit (no
              ``route`` span in the router's trace) is byte-equal to its
              body's first answer and their count is the router's, the tags
              agree with the CPU's on >= 0.99 of tokens, each replica's
              ``/healthz`` counts K1 fwd launches, the router's ``/metrics``
              counts the retries and every request sent through it, and
              SIGTERM ends the fleet with exit 0 and no replica left; printed
              beside the card's name and power limit: p50/p99 of the load,
              via the router and direct, the hit rate, retries, the seconds
              from the kill to ready, each replica's peak memory and K1
              launches. The fleet runs with ``--model-manifest`` (cnn, the
              default, and "hot", the same directory under a second name, a
              class target of 1 ms that every window breaches), ``--watch``
              over a directory of its own (empty at the start: nothing is
              split), ``--canary-fraction 0.5 --guard-min-samples 400`` (the
              guard's bounds at their defaults) and ``--autoscale
              --min-replicas 2 --max-replicas 2``. After those checks, once
              both replicas' 30-s latency windows are empty (replica 1
              served the kill's half and the paired requests alone; the
              guard compares the windows), while 4 clients send fresh
              bodies, serve:watch's last generation is published into
              the watched directory (copied under a temporary name, then
              renamed): the controller canaries it on replica 1, the router
              splits, the guard promotes, both replicas' ``/healthz`` show
              the stamp, the cache is flushed, no request fails, and the
              answers stamped with it agree with the generation's params
              on the CPU on >= 0.99 of tokens (the seconds from the
              publication to each replica's flip from their traces, and
              both windows' p99 as last read before the promotion). Then,
              at once: a generation of train:md's model (another tree)
              published above it, which each replica's ``/admin/swap``
              answers 409 and the controller rejects once while the fleet
              stays on the first stamp; "hot" (loaded on replica 1 while
              replica 0 restarted) gets its traffic (``X-SRT-Model``) there
              until the placement
              tick loads it onto replica 0 (``placement_decisions`` on the
              router's ``/metrics``, "hot" resident on both, its answers
              the CPU's); ``telemetry collect-trace`` on the router's URL
              merging the router's and both replicas' traces into one file.
              No request fails. Between the checks above and the rollout, with
              the replicas idle, nel:assets, the linker's kernel rows and
              train:nel run (18), so their seconds cover the windows' wait.

26. cli:train_and_serve (beside train:fleet_async and the host's own work
              before the training kernels' rows) — ``python -m
              spacy_ray_tpu_torch train-and-serve configs/cnn.cfg --output
              <dir> --replicas 1 --port 0`` on train:cnn's .spacy corpora
              (16 dev docs), a generation every 10 steps, patience 0 (no
              early stop before the SIGTERM): it bootstraps
              from the run's first best-model, one client's requests through
              its router until their answers carry two generations (a flip
              between two requests: the controller's direct rollout), then
              one SIGTERM. Fails unless
              no request failed, the tree exits 0 with the trainer's 75
              (interrupted at a step boundary, its generation written) and
              no process of it is left; printed: the seconds to the
              bootstrap, to ready, to the flip and of the drain.

27. train:faults (beside train:fleet_async, cli:train_and_serve and
              the host's own work) — ``train configs/cnn.cfg --max-restarts
              1 --metrics-dir ... --training.watchdog_timeout_s 15`` (40
              steps, an evaluation every 10, on the udgen .jsonl corpus) with
              ``SPACY_RAY_TPU_FAULT_PLAN="corpus-read:1:oserror,
              checkpoint-write:1:oserror,step:7:nan"`` and a ``--code``
              callback that hangs for 30 s once, before step 16 (after the
              step-10 generation): each attempt retries its first corpus
              open and its first generation's write, reports step 7's loss
              as NaN (the first evaluation after it a non-finite
              ``loss_total``, a ``nan-loss`` anomaly in ``metrics.jsonl`` and
              in the ``JsonlLogger.v1`` rows); the first exits 79 with a
              thread dump naming the callback, the supervisor restarts it
              with ``--resume`` (a ``resume`` event at step 10) and the run
              ends 0 with ``last-model/``. K1 fwd, K1 bwd and K5 launch in
              each attempt (the callback writes its process's counts).

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before the last line. Without a card, or without the package beside this
file, it exits 2 and prints no result.
"""

from __future__ import annotations

import bisect
import io
import itertools
import json
import math
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager, nullcontext, redirect_stdout
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
STREAM_COPIES = 16              # K1 fwd back to back: 16 copies of each table, past L2

# tolerances of kernel vs plain version on the same inputs
TOL_K1 = 0.0        # the same four f32 adds in the same order: bit-equal
TOL_K2_O = 1e-2     # bf16 output: about 1 ulp at |o| ~ 2 (2**-7 = 7.8e-3)
TOL_K2_LSE = 1e-3   # f32 log-sum-exp, different summation order
TOL_K4_REL = 1e-4   # f32 accumulation order, relative to max |out|
TOL_TRUNK = 0.1     # bf16 trunk after 12 layers, max |diff| on real tokens
TOL_K1_BWD = 0.0    # the same f32 adds in the same order as the CPU plain version
TOL_K3_F32 = 1e-3   # f32 dq/dk/dv, other summation order (tests/test_flash_attention.py)
TOL_K3_BF16 = 5e-2  # bf16 dq/dk/dv, relative to max |grad| (the JAX kernel probe's bound),
#                     over the rows with a real key and over all-masked rows apart
MAXULP_K5 = 1       # p, m, v against leaf_math_plain (bit-equal when no FMA is formed)
TOL_GRAD = 5e-2     # bf16 trunk gradients, kernels vs plain, relative to each leaf's max
TOL_GRAD_CNN = 1e-4  # f32 CNN gradients, the same measure: the kernels' adds in another order
TRAIN_STEPS, TRAIN_EVAL = 40, 20
TRF_CUT_DEPTH = 6  # train:trf, train:trf_init: trf.cfg's trunk at 6 of its 12 layers (time)
TRAIN_B, TRAIN_T = 64, 128  # one training microbatch (batch_by_words 2000 on this corpus)
CNN_WIDTH = 96              # configs/cnn.cfg and sm.cfg: HashEmbedCNN width 96, depth 4
CNN_STEPS, CNN_EVAL = 60, 20  # the CNN phases (train:cnn, sm, spancat, textcat, tokcls) cut
#                               max_steps and eval_frequency only
#: each CNN phase's dev floors at its last evaluation (spancat's and textcat's
#: are the JAX package's own tests' floors, tests/test_spancat_textcat.py)
DEV_FLOORS = {"spancat": {"spans_sc_f": 0.5, "cats_micro_f": 0.7},
              "textcat": {"cats_score": 0.7},
              "md": {"tag_acc": 0.9, "dep_las": 0.8, "ents_f": 0.8},
              "nel": {"nel_micro_f": 0.85}}
#: the linker's dev nel_micro_f must also clear the prior-only decode by this
#: much. train:nel holds only this one: on nel_assets' independent vectors its
#: DEV_FLOORS floor is reported, and held on the shared-direction KB
#: (train:nel_shared)
NEL_OVER_PRIOR = 0.3
#: md's lemma_acc floor, as a share of what the same rule lemmatizer scores
#: from the dev corpus's gold POS: the JAX package's rule lemmatizer
#: lower-cases a PROPN lemma (no rule table for PROPN), and the corpus's
#: PROPN lemmas keep their case, so that score is ~0.90 on this corpus
LEMMA_FLOOR_OF_GOLD_POS = 0.99
PROFILE_STEPS = 5           # train:cnn / train:sm steps under torch.profiler
MD_ROWS = (5000, 1000, 2500, 2500)  # spaCy md's tables: NORM, PREFIX, SUFFIX, SHAPE
MD_VECTORS = (20000, 300)   # en_core_web_md's vector width; synthetic rows from a seed

UD_TAGS = ["ADJ", "ADP", "ADV", "AUX", "CCONJ", "DET", "INTJ", "NOUN", "NUM",
           "PART", "PRON", "PROPN", "PUNCT", "SCONJ", "SYM", "VERB", "X"]
WORDS = ("the of and to in is was he for it with as his on be at by had are but "
         "from or have an they which one you were her all she there would their we "
         "him been has when who will more no if out so said what up its about into "
         "than them can only other new some could time these two may then do first "
         "any my now such like our over man me even most made after also did many "
         "before must through back years where much your way well down should because "
         "each just those people Mr how too little state good very make world still "
         "own see men work long get here between both life being under never day "
         "same another know while last might us great old year off come since against "
         "go came right used take three Paris London 1984 3.5 U.S. don't it's "
         "well-known e-mail").split()
PUNCT = [",", ".", ";", "!", "?", "(", ")"]


T_IMPORT = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_IMPORT}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def mean_or_none(xs):
    """The mean of ``xs``; None for an empty window (a problem of its own)."""
    return statistics.mean(xs) if xs else None


def grad_rel_errs(got, want, real) -> dict:
    """For each of dq, dk, dv: max |got - want| relative to max |want| over
    the same batch rows, taken apart for the rows with a real key (``real``,
    [B] bool) and the all-masked rows. An all-masked row recomputes p = 1 on
    every key, so its dq and dv are sums over all T keys or queries, an order
    larger than a real row's: one maximum over both would let a wrong real
    row pass."""
    errs = {"real": [], "masked": []}
    for x, y in zip(got, want):
        for name, rows in (("real", real), ("masked", ~real)):
            if bool(rows.any()):
                a, b = x[rows].float(), y[rows].float()
                errs[name].append((a - b).abs().max().item()
                                  / max(b.abs().max().item(), 1e-30))
    return errs


# ----------------------------------------------------------- measurement


def time_ms(torch, fn, *, reps: int = 25, warmup: int = 3, flush=None,
            spin_cap_s: float = 0.05) -> float:
    """Median device milliseconds of one call, each timed with CUDA events
    around the call alone. Before each call the card spins
    (``torch.cuda._sleep``) for about twice the host's time to enqueue it,
    at most ``spin_cap_s``, so its kernels run back to back and the host's
    launch cost is not counted. With ``flush``, L2 is overwritten before
    each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin = int(min(2 * host_s + 20e-6, spin_cap_s) * 2e9)  # cycles, at up to 2 GHz
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def back_to_back_ms(torch, fns, *, reps: int = 10, flush=None) -> float:
    """Median device milliseconds per call of the calls ``fns`` run back to
    back between one pair of CUDA events, after the card spins for twice the
    host's time to enqueue them all (so they queue up and the host's launch
    cost is not counted). With ``flush``, L2 is overwritten before each
    timed run."""
    def run():
        for fn in fns:
            fn()

    return time_ms(torch, run, reps=reps, warmup=1, flush=flush) / len(fns)


def enqueue_ms(torch, fn, *, reps: int = 10) -> float:
    """Median host milliseconds to enqueue one call, starting from an idle
    card. Close to the device time of the call when the host, not the
    card, sets the pace."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_us(torch, fn, *, reps: int = 100) -> float:
    """Mean host microseconds per call of back-to-back calls (the card runs
    behind; the launch queue is far from full at this count)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def train_lengths():
    """Lengths of a training microbatch's rows: about 36 docs of 8-120
    words, the rest batch-padding rows."""
    rng = random.Random(3)
    return [rng.randint(8, 120) for _ in range(36)] + [0] * (TRAIN_B - 36)


def corpus_keys(torch, g=None):
    """The hash keys [B*T, 2] of one training microbatch (B 64, T 128), as
    skewed as the training corpus makes them: a 45-word vocabulary, and
    every batch-padding position the zero key. Drawn first from ``g`` (a new
    generator of seed 1 when none is given, so that every caller gets the
    keys ``phase_train_kernels`` draws)."""
    dev = torch.device("cuda")
    if g is None:
        g = torch.Generator(device=dev).manual_seed(1)
    vocab = torch.randint(1, 2 ** 32, (45, 2), device=dev, generator=g)
    real = (torch.arange(TRAIN_T, device=dev)[None, :]
            < torch.tensor(train_lengths(), device=dev)[:, None]).reshape(-1)
    word = torch.randint(0, 45, (TRAIN_B * TRAIN_T,), device=dev, generator=g)
    return torch.where(real[:, None], vocab[word], torch.zeros_like(vocab[word]))


def ptxas_summary(log: str):
    """Registers, shared memory and spills of each kernel in an
    ``nvcc -Xptxas -v`` log."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            out.append({"kernel": name, "spill_stores": spills[0], "spill_loads": spills[1]})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name:
            smem = re.search(r"(\d+) bytes smem", line)  # absent: dynamic shared memory
            out[-1].update({"registers": int(m.group(1)),
                            "smem_static": int(smem.group(1)) if smem else 0})
    for row in out:  # mangled names: keep the kernel and its head dim or x type
        name = row["kernel"]
        if "gather_sum" in name:
            row["kernel"] = "gather_sum"
            continue
        if "fused_update" in name:  # keep the template arguments
            args = re.findall(r"L[bi](\d+)E", name.split("fused_update", 1)[1].split("EEv")[0])
            row["kernel"] = f"fused_update<{','.join(args)}>"
            continue
        k = re.search(r"\d((?:flash_(?:fwd|bwd)|int8|table_grad|reduce)_\w+?)[IE]", name)
        dh = re.search(r"ILi(\d+)E", name)
        xt = "<bf16>" if "I13__nv_bfloat16E" in name else "<f32>" if "IfE" in name else ""
        row["kernel"] = (k.group(1) if k else name[:40]) + (f"<{dh.group(1)}>" if dh else xt)
    return out


def device_ops(torch, fn) -> dict:
    """The device operations (kernels, copies, fills) that one call of
    ``fn`` puts on the card, by name: ``{name: [count, device ms]}``, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            count, ms = out.get(e.key[:60], (0, 0.0))  # names cut to 60 may collide
            out[e.key[:60]] = [count + e.count, ms + us / 1e3]
    return out


# ---------------------------------------------------------------- phases


def phase_kernels(torch):
    """Each kernel against its plain version and timed, at slice shapes."""
    import torch.nn.functional as F

    from spacy_ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain, key_padding,
    )
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids
    from spacy_ray_tpu_torch.ops.int8_matmul import (
        int8_matmul_plain, int8_weight_matmul, quantize_int8, split_k,
    )
    from spacy_ray_tpu_torch.ops.pallas_kernels import (
        hash_embed_gather_sum, hash_embed_gather_sum_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def flush():
        scratch.zero_()

    results = {}
    B, T, D, H, Dh = 8, 128, 768, 12, 64

    # K1: the four hash tables of one serving dispatch (NORM 20000, three of
    # 10000), then the NORM table for one one-text request (B 1, T 128) and
    # for a training microbatch (B 64, T 128) on the corpus's skewed ids.
    # The bound counts each distinct table row a call names once (repeated
    # ids can never lift the share past 100 %), the output and the ids;
    # bound_ms_all_rows counts four rows a token, as the earlier count did.
    # A call of a few microseconds sits on the timer's floor (an empty kernel
    # timed alike, timer_floor_ms), so ms_back_to_back also times the call's
    # throughput: STREAM_COPIES calls back to back, each on its own copy of
    # the table, so that every call reads its rows from HBM.
    shapes = []
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(1), flush=flush)
    tables = {rows: torch.randn(rows, D, device=dev, generator=g) for rows in (20000, 10000)}
    copies = {rows: [t.clone() for _ in range(STREAM_COPIES)] for rows, t in tables.items()}
    cases = []
    for rows in (20000, 10000):
        keys = torch.randint(0, 2 ** 32, (B * T, 2), device=dev, generator=g)
        cases.append((rows, hash_embed_ids(keys, 12345, rows), "uniform", "serving",
                      1 if rows == 20000 else 3))
    keys = torch.randint(0, 2 ** 32, (T, 2), device=dev, generator=g)
    cases.append((20000, hash_embed_ids(keys, 12345, 20000), "uniform", "one-request", 1))
    cases.append((20000, hash_embed_ids(corpus_keys(torch), 12345, 20000), "corpus-skewed",
                  "training", 1))
    for rows, ids, kind, dispatch, calls in cases:
        table = tables[rows]
        got = hash_embed_gather_sum(table, ids)
        want = hash_embed_gather_sum_plain(table, ids)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= TOL_K1:
            fail(f"K1 rows={rows} N={ids.shape[0]}: max_abs_err {err} > {TOL_K1}")
        ids_l = ids.long()
        n = ids.shape[0]
        distinct = int(torch.unique(ids).numel())
        bnd, by = bound_ms(distinct * D * 4 + n * D * 4 + n * 16, 3 * n * D, PEAK_F32_FLOPS)
        row = {
            "rows": rows, "D": D, "N": n, "ids": kind, "distinct_rows": distinct,
            "max_abs_err": err, "dispatch": dispatch,
            "ms": time_ms(torch, lambda: hash_embed_gather_sum(table, ids), flush=flush),
            "ms_back_to_back": back_to_back_ms(
                torch, [lambda t=t: hash_embed_gather_sum(t, ids) for t in copies[rows]],
                flush=flush),
            "host_us": host_us(torch, lambda: hash_embed_gather_sum(table, ids)),
            "plain_ms": time_ms(torch, lambda: hash_embed_gather_sum_plain(table, ids),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(ids_l, table, mode="sum"),
                                  flush=flush),
            "bound_ms": bnd, "bound_by": by,
            "bound_ms_all_rows": bound_ms(n * (4 * D * 4 + D * 4 + 16), 3 * n * D,
                                          PEAK_F32_FLOPS)[0],
            "calls_per_dispatch": calls,
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_bound_back_to_back"] = row["bound_ms"] / row["ms_back_to_back"]
        row["timer_floor_ms"] = floor_ms
        emit({"phase": "kernel:hash_embed_gather_sum", **row})
        shapes.append(row)
    results["hash_embed_gather_sum"] = shapes

    # K2: bf16 q/k/v as views of the fused qkv projection, ragged masks with
    # an all-masked batch-padding row, the key extent the trunk passes: the
    # serving shapes, and a training microbatch's (lengths and padding rows
    # as phase_train_kernels builds them; forward and remat recompute)
    shapes = []
    for b, t in ((B, T), (2, 512), (TRAIN_B, TRAIN_T)):
        qkv = torch.randn(b, t, 3 * D, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (x.view(b, t, H, Dh) for x in qkv.split(D, dim=-1))
        lens = (train_lengths() if b == TRAIN_B else
                [t] + [max(t - 29 * i, 1) for i in range(1, b - 1)] + [0])
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        bias, extent = key_padding(mask)
        scale = 1.0 / math.sqrt(Dh)
        o, lse = flash_attention_fwd(q, k, v, bias, scale, extent)
        o2, lse2 = flash_attention_plain(q, k, v, bias, scale)  # every key
        torch.cuda.synchronize()
        if not bool(torch.isfinite(o.float()).all()):
            fail("K2: non-finite output (the all-masked row must stay finite)")
        err = (o.float() - o2.float()).abs().max().item()
        err_lse = (lse - lse2).abs().max().item()
        if not (err <= TOL_K2_O and err_lse <= TOL_K2_LSE):
            fail(f"K2 B={b} T={t}: max_abs_err o {err} (tol {TOL_K2_O}), "
                 f"lse {err_lse} (tol {TOL_K2_LSE})")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        amask = bias.to(torch.bfloat16)[:, None, None, :]
        nbytes = 4 * b * t * H * Dh * 2 + b * t * 4 + b * t * H * 4
        flops = 4 * H * Dh * sum(n * n for n in lens)
        bnd, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        dispatch = ("serving" if (b, t) == (B, T) else "training" if b == TRAIN_B else None)
        row = {
            "B": b, "T": t, "H": H, "Dh": Dh, "dtype": "bf16", "max_abs_err": err,
            "lse_max_abs_err": err_lse,
            "ms": time_ms(torch, lambda: flash_attention_fwd(q, k, v, bias, scale, extent)),
            "host_us": host_us(torch, lambda: flash_attention_fwd(q, k, v, bias, scale, extent)),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(q, k, v, bias, scale)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask)),
            "bound_ms": bnd, "bound_by": by, "dispatch": dispatch,
            "calls_per_dispatch": {"serving": 12, "training": 24}.get(dispatch, 0),
        }
        emit({"phase": "kernel:flash_attention_fwd", **row})
        shapes.append(row)
    results["flash_attention_fwd"] = shapes

    # K4: the four trunk weights of one layer at the top bucket's M = B*T
    # (in the kernels line), and at M = 64 (two docs of 32 tokens, where the
    # weight bytes dominate), with bf16 x as the serving path gives it and
    # with f32 x (values that are not bf16-exact); first ragged shapes that
    # take the kernel's guarded edges (K not a multiple of 16, rows not
    # 16-byte aligned), one of them with K split across CTAs
    shapes = []
    for M, K, N in ((37, 50, 70), (20, 770, 70), (129, 771, 136)):
        q8, s = quantize_int8(torch.randn(K, N, device=dev, generator=g))
        x = torch.randn(M, K, device=dev, generator=g)
        for xx in (x, x.to(torch.bfloat16)):
            want = int8_matmul_plain(xx, q8, s)
            err = (int8_weight_matmul(xx, q8, s) - want).abs().max().item()
            ref = want.abs().max().item()
            if not err <= TOL_K4_REL * ref:
                fail(f"K4 ragged M={M} K={K} N={N} x {xx.dtype}: max_abs_err {err} > "
                     f"{TOL_K4_REL} * {ref}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for M, K, N in [(m, k, n) for m in (B * T, 64)
                    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768))]:
        w = torch.randn(K, N, device=dev, generator=g) * 0.02
        q8, s = quantize_int8(w)
        xf = torch.randn(M, K, device=dev, generator=g)  # f32, not bf16-exact
        xb = xf.to(torch.bfloat16)                       # the serving path's input
        x = xb.float()                                   # its values in f32
        errs, refs = [], []
        for xx in (xb, xf):
            got = int8_weight_matmul(xx, q8, s)
            want = int8_matmul_plain(xx, q8, s)
            torch.cuda.synchronize()
            errs.append((got - want).abs().max().item())
            refs.append(want.abs().max().item())
            if not errs[-1] <= TOL_K4_REL * refs[-1]:
                fail(f"K4 K={K} N={N} x {xx.dtype}: max_abs_err {errs[-1]} > "
                     f"{TOL_K4_REL} * {refs[-1]}")
        w_deq = q8.float() * s  # made once: the library call is the product alone
        w_deq_bf16 = w_deq.to(torch.bfloat16)
        # bf16 x and |q8| <= 127: the bf16 tensor cores accumulating in f32
        # compute each product exactly, so the operations count at the bf16
        # peak; the bytes count x in its own type (2 bytes, 4 for f32 x,
        # which takes two products)
        bnd, by = bound_ms(M * K * 2 + K * N + N * 4 + M * N * 4, 2 * M * N * K, PEAK_BF16_FLOPS)
        bnd_f, by_f = bound_ms(M * K * 4 + K * N + N * 4 + M * N * 4, 4 * M * N * K,
                               PEAK_BF16_FLOPS)
        row = {
            "M": M, "K": K, "N": N, "x": "bf16", "max_abs_err": max(errs),
            "max_abs_err_bf16_f32x": errs, "max_abs_ref": refs,
            "k_splits": split_k(M, N, K, n_sm)[0],
            "ms": time_ms(torch, lambda: int8_weight_matmul(xb, q8, s), flush=flush),
            "host_us": host_us(torch, lambda: int8_weight_matmul(xb, q8, s)),
            "ms_f32x": time_ms(torch, lambda: int8_weight_matmul(xf, q8, s), flush=flush),
            "plain_ms": time_ms(torch, lambda: int8_matmul_plain(xb, q8, s), flush=flush),
            "library": "torch.mm (cuBLAS f32) of x's values and the dequantized weight",
            "library_ms": time_ms(torch, lambda: torch.mm(x, w_deq), flush=flush),
            "bf16_mm_ms": time_ms(torch, lambda: torch.mm(xb, w_deq_bf16), flush=flush),
            "bound_ms": bnd, "bound_by": by, "bound_ms_f32x": bnd_f, "bound_by_f32x": by_f,
            "dispatch": "serving" if M == B * T else None,
            "calls_per_dispatch": 12 if M == B * T else 0,
        }
        emit({"phase": "kernel:int8_weight_matmul", **row})
        shapes.append(row)
    results["int8_weight_matmul"] = shapes
    del scratch
    return results


def ulp_diff(torch, a, b) -> int:
    """Largest distance in float32 units in the last place between a and b."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item())


def trf_param_shapes(torch, train_path=None):
    """The shape of every parameter leaf, built on the CPU: of the trf.cfg
    trunk + tagger (17 tags), without initialising; with ``train_path``, of
    trf.cfg as written, every component's labels collected from that corpus
    as ``train()`` collects them (``Pipeline.initialize``)."""
    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training import corpus  # noqa: F401  (spacy.Corpus.v1)

    if train_path is None:
        nlp = Pipeline.from_config(trf_tagger_config().interpolate(), device="cpu")
        nlp.components["tagger"].labels = list(UD_TAGS)
        return [tuple(p.shape) for p in nlp._build_models().parameters()]
    cfg = trf_full_config()
    cfg["paths"] = {"train": str(train_path), "dev": str(train_path)}
    cfg = cfg.interpolate()
    nlp = Pipeline.from_config(cfg, device="cpu")
    nlp.initialize(registry.resolve(cfg["corpora"]["train"]), seed=0)
    return [tuple(p.shape) for p in nlp.model.parameters()]


def write_udgen_corpus():
    """The pseudo-UD corpus ``train:full`` trains on: 2000 train and 200 dev
    docs (seeds 0 and 1). Returns (train path, dev path)."""
    from spacy_ray_tpu_torch.udgen import write_ud_jsonl

    work = WORK / "udgen"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    write_ud_jsonl(work / "train.jsonl", 2000, seed=0)
    write_ud_jsonl(work / "dev.jsonl", 200, seed=1)
    return work / "train.jsonl", work / "dev.jsonl"


def phase_train_kernels(torch, full_shapes, moe_shapes):
    """The training path's kernels against their plain versions and timed:
    the hash-embed table gradient and the attention backward (K3) at one
    training microbatch's shapes (B 64, T 128: batch_by_words 2000 on this
    corpus takes up to 40 docs of up to 120 words), the fused update (K5)
    over every leaf of the trf + tagger parameter set at trf.cfg's depth
    (``build_model_dir``'s; ``train:trf`` runs at ``TRF_CUT_DEPTH``), of
    trf.cfg as written (``full_shapes``, the leaves ``train:full`` updates)
    and of trf.cfg with 8 experts (``moe_shapes``, ``train:moe``'s)."""
    import torch.nn.functional as F

    from spacy_ray_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain, key_padding,
    )
    from spacy_ray_tpu_torch.ops.fused_update import (
        FusedHyper, FusedUpdate, global_norm, leaf_math_plain, step_scalars,
    )
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids
    from spacy_ray_tpu_torch.ops.pallas_kernels import (
        hash_embed_table_grad, hash_embed_table_grad_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def flush():
        scratch.zero_()

    results = {}
    B, T, D, H, Dh = TRAIN_B, TRAIN_T, 768, 12, 64
    lens = train_lengths()

    # hash-embed table gradient: the four tables of one microbatch, with ids
    # as skewed as the training corpus makes them (a 45-word vocabulary, and
    # every batch-padding position hashing the zero key to the same rows),
    # and once with uniform ids
    corpus = corpus_keys(torch, g)
    shapes = []
    for rows, skewed in ((20000, True), (10000, True), (20000, False)):
        n = B * T
        ct = torch.randn(n, D, device=dev, generator=g)
        keys = (corpus if skewed else
                torch.randint(0, 2 ** 32, (n, 2), device=dev, generator=g))
        ids = hash_embed_ids(keys, 777, rows)
        got = hash_embed_table_grad(ct, ids, rows)
        again = hash_embed_table_grad(ct, ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K1 bwd rows={rows}: two runs on the same inputs differ")
        want_cpu = hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows)
        err = (got.cpu() - want_cpu).abs().max().item()
        if not err <= TOL_K1_BWD:
            fail(f"K1 bwd rows={rows}: max_abs_err {err} vs the CPU plain version > {TOL_K1_BWD}")

        ops = device_ops(torch, lambda: hash_embed_table_grad(ct, ids, rows))
        want = hash_embed_table_grad_plain(ct, ids, rows)
        err_card = (got - want).abs().max().item()
        flat = ids.reshape(-1).long()
        nbytes = rows * D * 4 + n * D * 4 + n * 16
        bnd, by = bound_ms(nbytes, 4 * n * D, PEAK_F32_FLOPS)
        row = {
            "rows": rows, "D": D, "N": n, "ids": "corpus-skewed" if skewed else "uniform",
            "longest_segment": int(torch.bincount(ids.reshape(-1).long()).max()),
            "max_abs_err": err, "max_abs_err_vs_card_plain": err_card,
            "ms": time_ms(torch, lambda: hash_embed_table_grad(ct, ids, rows), flush=flush),
            "host_us": host_us(torch, lambda: hash_embed_table_grad(ct, ids, rows)),
            "launches_per_call": sum(n for n, _ in ops.values()),
            "device_ms_by_op": ops,
            "bit_identical_rerun": True,
            "plain_ms": time_ms(torch, lambda: hash_embed_table_grad_plain(ct, ids, rows),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: torch.zeros(rows, D, device=dev).index_add_(
                0, flat, ct.repeat_interleave(4, 0)), flush=flush),
            "bound_ms": bnd, "bound_by": by, "dispatch": "training" if skewed else None,
            "calls_per_dispatch": 0 if not skewed else 1 if rows == 20000 else 3,
        }
        emit({"phase": "kernel:hash_embed_table_grad", **row})
        shapes.append(row)
    results["hash_embed_table_grad"] = shapes

    # K3: q/k/v as views of the fused projection, ragged masks with an
    # all-masked batch-padding row, the key extent the trunk passes; a
    # nonzero lse cotangent on the check shapes, none on the training shape
    # (the trunk drops the lse). The forward (K2) is held against its plain
    # version on the same inputs, f32 included
    shapes = []
    for b, t, dt, with_dlse in ((3, 70, torch.float32, True), (3, 70, torch.bfloat16, True),
                                (B, T, torch.bfloat16, True), (B, T, torch.bfloat16, False)):
        qkv = torch.randn(b, t, 3 * D, device=dev, generator=g).to(dt)
        q, k, v = (x.view(b, t, H, Dh) for x in qkv.split(D, dim=-1))
        bl = lens if b == B else [t, 33, 0]
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(bl, device=dev)[:, None]
        bias, extent = key_padding(mask)
        scale = 1.0 / math.sqrt(Dh)
        o, lse = flash_attention_fwd(q, k, v, bias, scale, extent)
        o2, lse2 = flash_attention_plain(q, k, v, bias, scale)
        fwd_err = ((o.float() - o2.float()).abs().max().item(), (lse - lse2).abs().max().item())
        if not (fwd_err[0] <= TOL_K2_O and fwd_err[1] <= TOL_K2_LSE):
            fail(f"K2 {dt} B={b} T={t}: max_abs_err o, lse {fwd_err}")
        do = torch.randn(b, t, H, Dh, device=dev, generator=g).to(dt)
        dlse = torch.randn(b, t, H, device=dev, generator=g) if with_dlse else None
        got = flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, scale, extent)
        want = flash_attention_bwd_plain(q, k, v, bias, o, lse, do, dlse, scale)
        again = flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, scale, extent)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"K3 {dt} B={b} T={t}: two runs on the same inputs differ")
        if not all(bool(torch.isfinite(x.float()).all()) for x in got):
            fail("K3: non-finite gradient (the all-masked row must stay finite)")
        errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(got, want)]
        refs = [y.float().abs().max().item() for y in want]
        rel = grad_rel_errs(got, want, mask.any(dim=1))
        if dt == torch.float32 and not max(errs) <= TOL_K3_F32:
            fail(f"K3 f32 B={b} T={t}: max_abs_err {errs} > {TOL_K3_F32}")
        if dt == torch.bfloat16 and not max(rel["real"] + rel["masked"]) <= TOL_K3_BF16:
            fail(f"K3 bf16 B={b} T={t}: max err relative to max |grad| over the same rows "
                 f"{rel} > {TOL_K3_BF16}")
        row = {"B": b, "T": t, "H": H, "Dh": Dh, "dtype": str(dt).split(".")[-1],
               "dlse": with_dlse, "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs,
               "max_abs_ref": refs, "rel_err_real_rows": rel["real"],
               "rel_err_masked_rows": rel["masked"], "fwd_max_abs_err_o_lse": fwd_err,
               "bit_identical_rerun": True, "dispatch": None, "calls_per_dispatch": 0}
        if b == B and not with_dlse:
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
            amask = bias.to(dt)[:, None, None, :]
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
            dot = do.transpose(1, 2)
            n_pairs = sum(n * n for n in bl)
            nbytes = 8 * b * t * H * Dh * 2 + b * t * H * 4 + b * t * 4
            bnd, by = bound_ms(nbytes, 8 * H * Dh * n_pairs, PEAK_BF16_FLOPS)
            row.update({
                "ms": time_ms(torch, lambda: flash_attention_bwd(
                    q, k, v, bias, o, lse, do, None, scale, extent)),
                "host_us": host_us(torch, lambda: flash_attention_bwd(
                    q, k, v, bias, o, lse, do, None, scale, extent)),
                "plain_ms": time_ms(torch, lambda: flash_attention_bwd_plain(
                    q, k, v, bias, o, lse, do, None, scale)),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)),
                "bound_ms": bnd, "bound_by": by, "dispatch": "training",
                "calls_per_dispatch": 12,
            })
        emit({"phase": "kernel:flash_attention_bwd", **row})
        shapes.append(row)
    results["flash_attention_bwd"] = shapes

    # K5: every leaf of the trf + tagger parameter set (slice:auto's) and of
    # trf.cfg as written (train:full: the heads' leaves too, the odd-sized
    # out_b of nA elements among them), Adam as trf.cfg sets it (clip 1.0)
    # and the other branches on the same leaves; the kernels line totals
    # the set train:full updates
    del scratch
    rows = []
    for leaf_set, leaf_shapes in (("trf+tagger", trf_param_shapes(torch)),
                                  ("trf.cfg as written", full_shapes),
                                  (f"trf.cfg, n_experts {MOE_EXPERTS}", moe_shapes)):
        main_path = leaf_set == "trf.cfg as written"
        n_params = sum(math.prod(sh) for sh in leaf_shapes)
        P = [torch.randn(sh, device=dev, generator=g) for sh in leaf_shapes]
        G = [torch.randn(sh, device=dev, generator=g) * 1e-3 for sh in leaf_shapes]
        M = [torch.randn(sh, device=dev, generator=g) * 1e-4 for sh in leaf_shapes]
        V = [torch.rand(sh, device=dev, generator=g) * 1e-6 for sh in leaf_shapes]
        worst = 0
        worst_abs = 0.0
        for hyper in (FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0),
                      FusedHyper("adam", 0.9, 0.999, 1e-8, 0.0, 0.01, 0.0),
                      FusedHyper("radam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.01)):
            gnorm = global_norm(G)
            sc = step_scalars(hyper, 9, 9, lambda s: 0.001)
            Pk, Mk, Vk = ([x.clone() for x in X] for X in (P, M, V))
            FusedUpdate(hyper).step(Pk, G, Mk, Vk, gnorm, sc)
            for i in range(len(P)):
                want = leaf_math_plain(P[i], G[i], M[i], V[i], gnorm, *sc, hyper=hyper)
                for a, w in zip((Pk[i], Mk[i], Vk[i]), want):
                    worst = max(worst, ulp_diff(torch, a, w))
                    worst_abs = max(worst_abs, (a - w).abs().max().item())
            del Pk, Mk, Vk
        torch.cuda.synchronize()
        if not worst <= MAXULP_K5:
            fail(f"K5 over {leaf_set}: {worst} ulp from leaf_math_plain > {MAXULP_K5}")
        hyper = FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0)
        fused = FusedUpdate(hyper)
        gnorm = global_norm(G)
        sc = step_scalars(hyper, 9, 9, lambda s: 0.001)

        def plain_all():
            for p, gg, m, v in zip(P, G, M, V):
                leaf_math_plain(p, gg, m, v, gnorm, *sc, hyper=hyper)

        lib_params = [p.clone().requires_grad_(True) for p in P]
        for p, gg in zip(lib_params, G):
            p.grad = gg
        lib_opt = torch.optim.Adam(lib_params, lr=1e-3, fused=True)
        bnd, by = bound_ms(28 * n_params, 20 * n_params, PEAK_F32_FLOPS)
        row = {
            "leaf_set": leaf_set, "leaves": len(P), "params": n_params,
            "odd_sized_leaves": sum(math.prod(sh) % 4 != 0 for sh in leaf_shapes),
            "max_ulp": worst, "max_abs_err": worst_abs,
            "ms": time_ms(torch, lambda: fused.step(P, G, M, V, gnorm, sc), reps=10),
            "host_us": host_us(torch, lambda: fused.step(P, G, M, V, gnorm, sc), reps=10),
            "global_norm_ms": time_ms(torch, lambda: global_norm(G), reps=10),
            "plain_ms": time_ms(torch, plain_all, reps=5, warmup=1),
            "library_ms": time_ms(torch, lib_opt.step, reps=10),
            "bound_ms": bnd, "bound_by": by,
            "dispatch": "training" if main_path else None,
            "calls_per_dispatch": 1 if main_path else 0,
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        # the chunks of the table the timed launches ran over
        row["chunks"] = fused._table.shape[0]
        row["scalar_chunks"] = int((fused._table[:, 5] == 0).sum())
        emit({"phase": "kernel:fused_update", **row})
        rows.append(row)
        del P, G, M, V, lib_params, lib_opt
        torch.cuda.empty_cache()
    results["fused_update"] = rows
    return results


def make_texts(n: int, seed: int):
    rng = random.Random(seed)
    lengths = [3, 8, 15, 30, 60, 100, 5, 90, 12, 45, 2, 80]  # words; <= 128 tokens
    texts = []
    for i in range(n):
        words = []
        for _ in range(lengths[i % len(lengths)]):
            words.append(rng.choice(WORDS) if rng.random() > 0.12 else rng.choice(PUNCT))
        texts.append(" ".join(words))
    return texts


def post(port: int, texts, timeout: float = 60.0, request_id=None):
    headers = {"Content-Type": "application/json"}
    if request_id is not None:
        headers["X-SRT-Request-Id"] = request_id
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/parse", data=json.dumps({"texts": texts}).encode(),
        headers=headers,
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


@contextmanager
def plain_kernels():
    """Swap every kernel of the trunk's path for its plain version (used only
    to produce the reference output; the port itself has no such switch)."""
    import spacy_ray_tpu_torch.models.layers as L
    import spacy_ray_tpu_torch.models.transformer as TR
    from spacy_ray_tpu_torch.ops.flash_attention import flash_attention_plain
    from spacy_ray_tpu_torch.ops.int8_matmul import int8_matmul_plain
    from spacy_ray_tpu_torch.ops.pallas_kernels import hash_embed_gather_sum_plain

    def lookup(table, ids):
        flat = ids.reshape(-1, 4)
        return hash_embed_gather_sum_plain(table, flat).reshape(*ids.shape[:-1], -1)

    def attention(q, k, v, keys):  # over every key: the kernels' extent is checked too
        return flash_attention_plain(q, k, v, keys.bias, q.shape[-1] ** -0.5)[0]

    def int8mm(x, q8, scale):
        x2 = x.reshape(-1, x.shape[-1]).float()
        return int8_matmul_plain(x2, q8, scale).reshape(*x.shape[:-1], -1)

    with mock.patch.object(L, "hash_embed_lookup", lookup), \
            mock.patch.object(TR, "masked_attention", attention), \
            mock.patch.object(TR, "int8_matmul", int8mm):
        yield


def trf_tagger_config():
    """configs/trf.cfg with its transformer and tagger blocks as they are and
    the parser and NER heads removed."""
    cfg = trf_full_config()
    cfg["nlp"]["pipeline"] = ["transformer", "tagger"]
    for name in ("parser", "ner"):
        cfg["components"].pop(name)
    return cfg


def trf_full_config():
    """configs/trf.cfg as written: the trunk with the tagger, parser and NER
    heads, its [training] block and score weights."""
    from spacy_ray_tpu_torch import Config

    cfg = Config.from_disk(ROOT / "configs" / "trf.cfg")
    if cfg["nlp"]["pipeline"] != ["transformer", "tagger", "parser", "ner"]:
        fail(f"configs/trf.cfg pipeline = {cfg['nlp']['pipeline']}")
    model = cfg["components"]["transformer"]["model"]
    for key, want in (("width", 768), ("depth", 12), ("n_heads", 12), ("ffn_mult", 4),
                      ("max_len", 512), ("embed_size", 20000)):
        if model[key] != want:
            fail(f"configs/trf.cfg {key} = {model[key]}, expected {want}")
    return cfg


def grad_errs_vs_plain(torch, nlp, params, batch, plain_out=None) -> dict:
    """{leaf: max |g - g_plain| / max |g_plain|}: the gradients of one
    microbatch (dropout off) with every kernel and with every kernel swapped
    for its plain version (kept in ``plain_out`` when it is given)."""
    grads = []
    for plain in (False, True):
        for p in params.values():
            p.grad = None
        if plain:
            with plain_kernels():
                nlp.loss(batch["tokens"], batch["targets"], dropout=0.0)[0].backward()
        else:
            nlp.loss(batch["tokens"], batch["targets"], dropout=0.0)[0].backward()
        grads.append({k: p.grad.detach().clone() for k, p in params.items()})
    if plain_out is not None:
        plain_out.update(grads[1])
    return {k: (grads[0][k] - grads[1][k]).abs().max().item()
            / max(grads[1][k].abs().max().item(), 1e-30) for k in params}


def build_model_dir(torch) -> Path:
    """The trf.cfg trunk with the tagger head, random weights from seed 0."""
    from spacy_ray_tpu_torch import Pipeline

    cfg = trf_tagger_config()
    t0 = time.perf_counter()
    nlp = Pipeline.from_config(cfg.interpolate(), device="cuda")
    nlp.initialize(labels={"tagger": UD_TAGS}, seed=0)
    n_params = sum(p.numel() for p in nlp.model.parameters())
    out = WORK / "trf_tagger"
    nlp.to_disk(out)
    emit({"phase": "model", "dir": str(out.relative_to(ROOT)), "params": n_params,
          "seconds": time.perf_counter() - t0})
    del nlp
    torch.cuda.empty_cache()
    return out


def phase_slice(torch, model_dir: Path, precision: str):
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.doc import Example

    t0 = time.perf_counter()
    server = build_server([str(model_dir), "--port", "0", "--max-batch", "8",
                           "--max-doc-len", "128", "--precision", precision])
    engine = server.engine
    nlp = engine.nlp
    try:
        _, port = server.start()
        engine.start()
        setup_s = time.perf_counter() - t0
        status, health = get(port, "/healthz")
        if status != 200 or health["status"] != "ok":
            fail(f"/healthz answered {status} {health}")

        texts = make_texts(24, seed=1)
        latencies = []
        answers = []
        lock = threading.Lock()

        def client(batch):
            for ts in batch:
                t = time.perf_counter()
                status, body = post(port, ts)
                with lock:
                    latencies.append(time.perf_counter() - t)
                    answers.append((status, ts, body))

        # 4 sequential single-text requests, then 4 concurrent clients each
        # sending 3 requests of 1-2 texts
        sequential = [[t] for t in texts[:4]]
        concurrent = [[[texts[4 + 5 * c + i]] if i % 2 else texts[4 + 5 * c + i: 6 + 5 * c + i]
                       for i in range(3)] for c in range(4)]
        _cuda.reset_launch_counts()
        client(sequential)
        threads = [threading.Thread(target=client, args=(c,)) for c in concurrent]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()

        n_tokens = 0
        batches = set()
        for status, ts, body in answers:
            if status != 200:
                fail(f"/v1/parse answered {status}: {body}")
            if len(body["docs"]) != len(ts):
                fail(f"/v1/parse returned {len(body['docs'])} docs for {len(ts)} texts")
            for d in body["docs"]:
                if len(d.get("tags", [])) != len(d["tokens"]) or not all(
                        t in UD_TAGS for t in d["tags"]):
                    fail(f"untagged or mis-tagged doc: {d}")
                n_tokens += len(d["tokens"])
            batches.add((body["batch"]["B"], body["batch"]["T"], body["batch"]["occupancy"]))
        need = ["hash_embed_gather_sum", "flash_attention_fwd"]
        if precision == "int8":
            need.append("int8_weight_matmul")
        missing = [k for k in need if launches[k] == 0]
        if missing:
            fail(f"precision={precision}: kernels never launched on the main path: {missing}")

        # trunk output of one batch: kernels vs plain versions, same pipeline
        docs = [nlp.tokenizer(t) for t in texts[:8]]
        batch = nlp.collate([Example.from_gold(d) for d in docs])
        overlay = engine.overlay.overlay
        with torch.inference_mode():
            out_k = nlp.forward(batch["tokens"], overlay)
            with plain_kernels():
                out_p = nlp.forward(batch["tokens"], overlay)
        mask = batch["tokens"].mask
        xk, xp = out_k["transformer"].X[mask], out_p["transformer"].X[mask]
        if not bool(torch.isfinite(xk).all()):
            fail("trunk output is not finite")
        trunk_err = (xk - xp).abs().max().item()
        tags_k = out_k["tagger"].X[mask].argmax(-1)
        tags_p = out_p["tagger"].X[mask].argmax(-1)
        agree = (tags_k == tags_p).float().mean().item()
        if not trunk_err <= TOL_TRUNK:
            fail(f"trunk kernels vs plain: max_abs_err {trunk_err} > {TOL_TRUNK}")
        if agree < 0.95:
            fail(f"tags kernels vs plain agree on only {agree:.3f} of tokens")

        # one forward at the top serving bucket (B=8, T=128): device time
        # with the kernels and with their plain versions, and the host's
        # time to enqueue it
        top = nlp.collate([Example.from_gold(d) for d in docs], pad_batch_to=8,
                          pad_len_to=128)["tokens"]

        def forward():
            nlp.forward(top, overlay)

        with torch.inference_mode():
            forward_ms = time_ms(torch, forward, reps=10)
            forward_enqueue_ms = enqueue_ms(torch, forward)
            with plain_kernels():
                forward_plain_ms = time_ms(torch, forward, reps=10)

        server.request_shutdown()
        rc = server.wait()
        if rc != 0:
            fail(f"serve drain returned {rc}")
        result = {
            "phase": f"slice:{precision}", "precision_label": engine.overlay.label,
            "requests": len(answers), "tokens": n_tokens, "batches_seen": sorted(batches),
            "launches": launches, "latency_p50_ms": percentile(latencies, 0.50) * 1e3,
            "latency_p99_ms": percentile(latencies, 0.99) * 1e3,
            "setup_s": setup_s, "warmed_buckets": len(engine.warmed),
            "trunk_max_abs_err": trunk_err, "trunk_tol": TOL_TRUNK,
            "tag_agreement": agree, "forward_B8_T128_ms": forward_ms,
            "forward_B8_T128_enqueue_ms": forward_enqueue_ms,
            "forward_B8_T128_plain_ms": forward_plain_ms,
        }
        emit(result)
        return result
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine, nlp
        torch.cuda.empty_cache()


FLEET_SERVE_CLIENTS = 4      # serve:fleet: closed-loop clients through the router
FLEET_SERVE_REQUESTS = 300   # requests of 1-8 dev texts; replica 0 SIGKILLed at the half
FLEET_SERVE_REPEAT = 0.3     # share of requests that repeat an answered body (cache hits)
FLEET_SERVE_CALM = 100       # fresh bodies sent one at a time, via the router and direct in turns
FLEET_SERVE_BACK_S = 60.0    # the killed replica must be back in rotation within this
# the rollout, the mismatched generation and placement on the same fleet
FLEET_CANARY_FRACTION = 0.5  # one of the two replicas canaries
FLEET_WATCH_INTERVAL_S = 0.5  # the controller's scans of the watched directory
# canary requests and window samples before a verdict: a swap stalls the
# requests in flight on its replica by tens of ms, and the canary's window
# holds its own swap while the baseline's does not; at 10 samples the p99 is
# the window's maximum and the default 1.5 x bound rolled a good generation
# back on the H100 (PERF.md; bin/fleet_rollout_check.py), at 400 it is the
# 4th-highest sample
FLEET_GUARD_MIN_SAMPLES = 400
FLEET_ROLLOUT_S = 90.0       # publication to both replicas on the stamp
FLEET_HOLD_S = 2.0           # the fleet stays on the first stamp this long after the refusal
FLEET_PLACE_TARGET_MS = 1.0  # the manifest's class target: every window breaches it
FLEET_PLACE_S = 60.0         # the placement move must come within this
FLEET_MISMATCH_OFFSET = 1000  # the mismatched generation's stamp above the first


def fleet_request(port: int, texts, request_id: str, model=None):
    """POST one body (``model``: as ``X-SRT-Model``): (status, raw bytes,
    seconds); a 5xx is a status too."""
    headers = {"Content-Type": "application/json", "X-SRT-Request-Id": request_id}
    if model is not None:
        headers["X-SRT-Model"] = model
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/parse", data=json.dumps({"texts": texts}).encode(),
        headers=headers)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    return status, raw, time.perf_counter() - t


def replica_state(row: dict) -> str:
    """What a replica of the router's roster ``row`` says of itself: its
    process's state and kernel wait channel, and its own ``/healthz``."""
    said = []
    pid, port = row.get("pid"), row.get("port")
    try:
        with open(f"/proc/{pid}/status") as f:
            said += [l.strip() for l in f if l.startswith(("State:", "Threads:", "VmRSS:"))]
        with open(f"/proc/{pid}/wchan") as f:
            said.append(f"wchan: {f.read().strip()}")
    except (OSError, TypeError):
        said.append(f"pid {pid}: no process")
    if port:
        try:
            said.append(f"healthz: {get(int(port), '/healthz')}")
        except (OSError, ValueError) as e:
            said.append(f"healthz: {e!r}")
    return f"replica {row.get('id')}: " + ", ".join(said)


def proc_gone(pid: int) -> bool:
    """True when ``pid`` runs no more (absent, or a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def start_serve_fleet(cnn_dir: Path, device: str = "cuda") -> dict:
    """Start ``python -m spacy_ray_tpu_torch serve-fleet <cnn_dir>
    --replicas 2 --port 0`` with a manifest (cnn, the default, and "hot",
    the same directory), an empty watched directory and the autoscaler
    held at two replicas (the router and two replica processes take ~25 s
    to come up, most of it importing torch); its output (``--verbose``: the
    controller's and the placement's events) is read on a thread.
    :func:`phase_serve_fleet` drives it."""
    import os

    work = WORK / "fleet_serve"
    shutil.rmtree(work, ignore_errors=True)
    (work / "watch").mkdir(parents=True)
    manifest = work / "manifest.json"
    manifest.write_text(json.dumps({
        "default_model": "cnn",
        "models": {"cnn": {"path": str(cnn_dir)}, "hot": {"path": str(cnn_dir)}},
        "classes": {"tight": {"weight": 1, "p99_target_ms": FLEET_PLACE_TARGET_MS}},
    }), encoding="utf-8")
    run = {"cnn_dir": cnn_dir, "t0": time.perf_counter(), "lines": [], "work": work,
           "watch": work / "watch"}
    run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve-fleet", str(cnn_dir),
         "--replicas", "2", "--device", device, "--port", "0", "--max-batch", "8",
         "--max-doc-len", "128", "--probe-interval-s", "0.2",
         "--model-manifest", str(manifest), "--watch", str(work / "watch"),
         "--watch-interval-s", str(FLEET_WATCH_INTERVAL_S),
         "--canary-fraction", str(FLEET_CANARY_FRACTION),
         "--guard-min-samples", str(FLEET_GUARD_MIN_SAMPLES),
         "--autoscale", "--min-replicas", "2", "--max-replicas", "2",
         "--autoscale-interval-s", "1", "--up-consecutive", "2", "--verbose"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, start_new_session=True)

    def read():
        for line in run["proc"].stdout:
            run["lines"].append(line.rstrip())
            if line.startswith("fleet ready:"):
                run["ready_at"] = time.perf_counter()

    run["reader"] = threading.Thread(target=read, daemon=True)
    run["reader"].start()
    return run


def publish_generation(src: Path, stamp: int, dst: Path, as_stamp: int) -> float:
    """Generation ``stamp`` of the checkpoint directory ``src`` (its params
    file and meta) into ``dst`` as ``as_stamp``: each file copied under a
    temporary name and renamed, the meta last, so a scan sees all of it or
    nothing. Returns the unix time of the meta's rename."""
    import os

    meta = json.loads((src / f"train_meta-{stamp}.json").read_text(encoding="utf8"))
    meta.update(stamp=as_stamp, step=as_stamp,
                digests={f"params-{as_stamp}.npz": meta["digests"][f"params-{stamp}.npz"]})
    tmp = dst / f".tmp-params-{as_stamp}.npz"
    shutil.copyfile(src / f"params-{stamp}.npz", tmp)
    os.replace(tmp, dst / f"params-{as_stamp}.npz")
    tmp = dst / f".tmp-train_meta-{as_stamp}.json"
    tmp.write_text(json.dumps(meta), encoding="utf8")
    os.replace(tmp, dst / f"train_meta-{as_stamp}.json")
    return time.time()


def flip_unix(port: int, stamp: int):
    """The unix time a replica's swap to ``stamp`` flipped, from its trace's
    ``swap_flip`` span and the trace's clock anchor (None without one)."""
    _, trace = get(port, "/trace")
    anchor = trace["anchor"]
    for e in trace["traceEvents"]:
        if e.get("name") == "swap_flip" and e.get("args", {}).get("generation") == stamp:
            end = anchor["origin"] + (e["ts"] + e["dur"]) / 1e6
            return anchor["unix_now"] - (anchor["clock_now"] - end)
    return None


class FleetLoad:
    """``FLEET_SERVE_CLIENTS`` closed-loop clients through the router, each
    request a body of 1-4 of ``texts`` for a model of ``models`` in turn
    (None: the default); ``rows`` holds (model, texts, status, raw, sent at
    perf_counter, seconds)."""

    def __init__(self, port: int, texts, models=(None,), seed: int = 2, tag: str = "load"):
        self.port, self.texts, self.models, self.tag = port, texts, models, tag
        self.rng = random.Random(seed)
        self.rows, self.lock, self.stop_ev = [], threading.Lock(), threading.Event()
        self.n = itertools.count()
        self.threads = [threading.Thread(target=self.client, daemon=True)
                        for _ in range(FLEET_SERVE_CLIENTS)]

    def client(self):
        while not self.stop_ev.is_set():
            with self.lock:
                i = next(self.n)
                body = [self.rng.choice(self.texts) for _ in range(self.rng.randint(1, 4))]
            model = self.models[i % len(self.models)]
            t = time.perf_counter()
            status, raw, sec = fleet_request(self.port, body, f"{self.tag}-{i}", model)
            with self.lock:
                self.rows.append((model, body, status, raw, t, sec))

    def __enter__(self):
        for th in self.threads:
            th.start()
        return self

    def __exit__(self, *exc):
        self.stop_ev.set()
        for th in self.threads:
            th.join(timeout=180)

    def failed(self):
        return [(m, status, raw[:200]) for m, _, status, raw, _, _ in self.rows if status != 200]

    def answered(self, model, generation):
        """(served docs, texts) of the 200s for ``model`` stamped ``generation``."""
        got, texts = [], []
        for m, body, status, raw, _, _ in self.rows:
            if m == model and status == 200:
                payload = json.loads(raw)
                if payload["batch"].get("generation") == generation:
                    got.extend(payload["docs"])
                    texts.extend(body)
        return got, texts


def stop_serve_fleet(run: dict) -> None:
    """Kill the fleet's process group if it still runs (a phase failed)."""
    import os
    import signal

    if run["proc"].poll() is None:
        os.killpg(run["proc"].pid, signal.SIGKILL)
        run["proc"].wait(timeout=30)


def phase_serve_fleet(torch, run: dict, dev_path: Path, smi: str, gens: dict,
                      beside=None) -> dict:
    """The serving fleet :func:`start_serve_fleet` started on train:cnn's
    model: two replica processes on the card behind the router. The bodies
    are drawn and the same model annotates their texts on the CPU in this
    process while it comes up. Then ``FLEET_SERVE_CLIENTS`` clients send
    ``FLEET_SERVE_REQUESTS`` bodies of 1-8 dev texts through the router,
    ``FLEET_SERVE_REPEAT`` of them repeats of an answered body, and replica
    0 (its pid from the router's roster) is SIGKILLed at the half. Then
    ``FLEET_SERVE_CALM`` fresh bodies go one at a time through the router and
    straight to replica 1, in turns (the router's own cost: the median of the
    pairs' differences), while replica 0 restarts. Fails unless no request failed (no 5xx), replica 0 is
    back in rotation, restarted by the supervisor, within
    ``FLEET_SERVE_BACK_S``, every cache hit (a request the router's trace
    shows no ``route`` span for) is byte-equal to its body's first answer and
    their count is the router's ``cache_hits``, the served tags equal the
    CPU's for >= 0.99 of tokens, every replica's ``/healthz`` counts K1 fwd
    launches, the router's ``/metrics`` counts the retries and as many
    requests as were sent through it, and SIGTERM ends the fleet with exit 0
    and no replica left. Before the SIGTERM, :func:`fleet_rollout` and
    :func:`fleet_refusal_and_placement` (``gens``: the generation to roll
    out, ``{"dir", "stamp"}``, and ``"mismatch"``, a checkpoint directory of
    another pipeline). ``beside``, if given, runs between the two while the
    replicas idle and their latency windows empty."""
    import os
    import signal

    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.training.checkpoint import Checkpoints
    from spacy_ray_tpu_torch.training.corpus import Corpus

    phase = "serve:fleet"
    t_phase = time.perf_counter()
    cnn_dir, t0, proc, lines = run["cnn_dir"], run["t0"], run["proc"], run["lines"]
    pids = set()
    try:
        # the host's work while the fleet comes up: the bodies, and the CPU's tags
        texts = [" ".join(eg.reference.words) for eg in Corpus(dev_path)()
                 if len(eg.reference.words) <= 100]
        rng = random.Random(0)
        seen, fresh = set(), []
        while len(fresh) < FLEET_SERVE_REQUESTS + FLEET_SERVE_CALM:
            body = tuple(rng.choice(texts) for _ in range(rng.randint(1, 8)))
            if body not in seen:
                seen.add(body)
                fresh.append(list(body))
        calm, fresh = fresh[FLEET_SERVE_REQUESTS:], fresh[:FLEET_SERVE_REQUESTS]
        repeat = [i > 0 and rng.random() < FLEET_SERVE_REPEAT
                  for i in range(FLEET_SERVE_REQUESTS)]
        cpu = Pipeline.from_disk(cnn_dir, device="cpu")
        t = time.perf_counter()
        distinct = sorted({x for body in fresh + calm for x in body})
        cpu_docs = [cpu.tokenizer(x) for x in distinct]
        cpu.predict_docs(cpu_docs)
        cpu_by_text = dict(zip(distinct, cpu_docs))
        cpu_s = time.perf_counter() - t

        def banner():
            return [l for l in lines if l.startswith("fleet serving on http://")]

        t_wait = time.perf_counter()
        end = t_wait + 300
        while time.perf_counter() < end and proc.poll() is None and "ready_at" not in run:
            time.sleep(0.05)
        if not banner() or not any(l.startswith("fleet ready: 2") for l in lines):
            fail(f"{phase}: the fleet did not come up:\n" + "\n".join(lines[-40:]))
        up_s, waited_s = run["ready_at"] - t0, time.perf_counter() - t_wait
        port = int(banner()[0].split("http://", 1)[1].split()[0].rsplit(":", 1)[1])
        roster = {r["id"]: r for r in get(port, "/metrics")[1]["replicas"]}
        if sorted(roster) != [0, 1] or not all(r["ready"] for r in roster.values()):
            fail(f"{phase}: roster {roster}")
        pids = {r["pid"] for r in roster.values()}
        victim = roster[0]["pid"]

        # the load, replica 0 SIGKILLed at the half
        bodies, answered, first = [], [], {}
        rows, lock, slots = [], threading.Lock(), iter(range(FLEET_SERVE_REQUESTS))
        pick = random.Random(1)
        t_kill = []

        def client():
            while True:
                with lock:
                    slot = next(slots, None)
                    if slot is None:
                        return
                    if repeat[slot] and answered:
                        b = answered[pick.randrange(len(answered))]
                    else:
                        b = len(bodies)
                        bodies.append(fresh[slot])
                    if slot == FLEET_SERVE_REQUESTS // 2:
                        os.kill(victim, signal.SIGKILL)
                        t_kill.append(time.perf_counter())
                status, raw, s = fleet_request(port, bodies[b], f"fleet-{slot}")
                with lock:
                    rows.append((slot, b, status, raw, s))
                    if status == 200 and b not in first:
                        first[b] = raw
                        answered.append(b)

        t_load = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(FLEET_SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        load_s = time.perf_counter() - t_load
        failed = [(slot, status, raw[:200]) for slot, _, status, raw, _ in rows if status != 200]
        if failed:
            fail(f"{phase}: {len(failed)} requests failed through the router: {failed[:5]}")

        # the router's own cost while replica 0 restarts: each fresh body once
        # via the router and once straight to replica 1, in turns (the order
        # alternating), one request at a time
        via, direct = [], []
        for i, body in enumerate(calm):
            for to in ((port, roster[1]["port"]) if i % 2 == 0 else (roster[1]["port"], port)):
                status, raw, s = fleet_request(to, body, f"calm-{i}-{to}")
                if status != 200:
                    fail(f"{phase}: calm request {i} to port {to} answered {status}: "
                         f"{raw[:200]}")
                if to == port:
                    via.append(s)
                    rows.append((None, None, status, raw, s))
                else:
                    direct.append(s)

        # the host's work while replica 0 restarts: the rolled-out generation's
        # tags of every dev text on the CPU, and the base model's of the rest
        t = time.perf_counter()
        cpu_gen = Pipeline.from_disk(cnn_dir, device="cpu")
        cpu_gen.load_params(Checkpoints(gens["dir"]).load_generation_params(
            gens["stamp"])["params"])
        every = sorted(set(texts))
        gen_docs = [cpu_gen.tokenizer(x) for x in every]
        cpu_gen.predict_docs(gen_docs)
        rest = [x for x in every if x not in cpu_by_text]
        rest_docs = [cpu.tokenizer(x) for x in rest]
        cpu.predict_docs(rest_docs)
        cpu_by_text.update(zip(rest, rest_docs))
        cpu_gen_by_text = dict(zip(every, gen_docs))
        cpu_gen_s = time.perf_counter() - t
        # and replica 1's copy of "hot", the placement drill's start
        t = time.perf_counter()
        admin(roster[1]["port"], "/admin/models/load", {"model": "hot"})
        hot_load_s = time.perf_counter() - t

        back = None
        while back is None and time.perf_counter() - t_kill[0] < FLEET_SERVE_BACK_S:
            r0 = {r["id"]: r for r in get(port, "/metrics")[1]["replicas"]}.get(0)
            if r0 and r0["ready"] and r0["pid"] not in (None, victim):
                back = (time.perf_counter() - t_kill[0], r0)
            else:
                time.sleep(0.1)
        if back is None:
            fail(f"{phase}: replica 0 not back in rotation {FLEET_SERVE_BACK_S:.0f} s after "
                 "its SIGKILL")
        back_s, restarted = back
        pids.add(restarted["pid"])

        _, trace = get(port, "/trace")
        forwarded = {e["args"].get("request_id") for e in trace["traceEvents"]
                     if e.get("name") == "route"}
        hits = [(slot, b, raw) for slot, b, status, raw, _ in rows
                if slot is not None and f"fleet-{slot}" not in forwarded]
        wrong = [slot for slot, b, raw in hits if raw != first[b]]
        _, metrics = get(port, "/metrics")
        router, cache = metrics["router"]["counters"], metrics["cache"]
        sent = FLEET_SERVE_REQUESTS + FLEET_SERVE_CALM
        if router.get("routed_canary", 0) or router.get("routed_baseline", 0):
            fail(f"{phase}: the router split traffic with no generation published: {router}")
        if wrong or len(hits) != cache["cache_hits"] or not hits:
            fail(f"{phase}: {len(hits)} cache hits by the trace, {cache['cache_hits']} by "
                 f"/metrics; not byte-equal to the first answer: {wrong[:5]}")
        if router["requests"] != sent or router.get("retries", 0) < 1:
            fail(f"{phase}: the router counted {router} for {sent} requests sent and one "
                 "replica killed under load")
        got, want = [], []
        for _, _, _, raw, _ in rows:
            docs = json.loads(raw)["docs"]
            got.extend(docs)
        for slot, b, *_ in rows[:len(rows) - len(calm)]:
            want.extend(cpu_by_text[x] for x in bodies[b])
        for body in calm:
            want.extend(cpu_by_text[x] for x in body)
        agree = agreement(cpu, got, want)
        if min(agree.values()) < 0.99:
            fail(f"{phase}: the fleet's tags agree with the CPU's only {agree}")
        health = {}
        for rid, r in sorted({r["id"]: r for r in metrics["replicas"]}.items()):
            _, h = get(r["port"], "/healthz")
            health[rid] = h
            if not h["kernel_launches"].get("hash_embed_gather_sum"):
                fail(f"{phase}: replica {rid} launched no K1 fwd: {h['kernel_launches']}")

        ports = {r["id"]: r["port"] for r in metrics["replicas"]}
        t = time.perf_counter()
        if beside is not None:
            beside()
        beside_s = time.perf_counter() - t
        live = {"rollout": fleet_rollout(phase, run, port, ports, texts, gens, cache,
                                         cpu_gen, cpu_gen_by_text)}
        live.update(fleet_refusal_and_placement(phase, run, port, ports, texts, gens, cpu,
                                                cpu_by_text, cpu_gen, cpu_gen_by_text))
        # the replicas' launches at the end, warmup, rollout and the second model included
        health = {rid: get(p, "/healthz")[1] for rid, p in sorted(ports.items())}

        t_stop = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
        stop_s = time.perf_counter() - t_stop
        run["reader"].join(timeout=10)
        left = [p for p in pids if not proc_gone(p)]
        if rc != 0 or left or "fleet drained; exiting 0" not in lines:
            fail(f"{phase}: SIGTERM gave exit {rc}, replicas left {left}:\n"
                 + "\n".join(lines[-20:]))
    finally:
        stop_serve_fleet(run)
        for p in pids:
            try:
                os.kill(p, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    load = sorted(s for slot, _, _, _, s in rows if slot is not None)
    result = {
        "phase": phase, "card": smi, "seconds": time.perf_counter() - t_phase,
        "since_start_s": time.perf_counter() - t0, "fleet_up_s": up_s,
        "waited_for_it_s": waited_s, "cpu_reference_s": cpu_s,
        "cpu_reference_generation_s": cpu_gen_s, "hot_load_s": hot_load_s, "load_s": load_s,
        "beside_s": beside_s, "stop_s": stop_s,
        "requests_through_router": sent, "router_requests": router["requests"],
        "retries": router.get("retries", 0), "routed": router.get("routed"),
        "no_5xx": True, "cache_hits": cache["cache_hits"],
        "cache_hit_rate": cache["cache_hits"] / (cache["cache_hits"] + cache["cache_misses"]),
        "cache_hits_byte_equal": True,
        "load_p50_ms": percentile(load, 0.50) * 1e3, "load_p99_ms": percentile(load, 0.99) * 1e3,
        "via_router_p50_ms": percentile(via, 0.50) * 1e3,
        "via_router_p99_ms": percentile(via, 0.99) * 1e3,
        "direct_p50_ms": percentile(direct, 0.50) * 1e3,
        "direct_p99_ms": percentile(direct, 0.99) * 1e3,
        "router_cost_median_ms": statistics.median(a - b for a, b in zip(via, direct)) * 1e3,
        "kill_to_ready_s": back_s, "restarts": restarted["restarts"],
        "card_vs_cpu_agreement": agree,
        "replicas": {str(rid): {"pid": next(r["pid"] for r in metrics["replicas"]
                                            if r["id"] == rid),
                                "peak_memory_bytes": h.get("peak_memory_bytes"),
                                "k1_fwd_launches": h["kernel_launches"]["hash_embed_gather_sum"]}
                     for rid, h in health.items()},
        "exit": rc, **live,
        # the two replicas alive at the end (the restarted one's count from
        # its restart), warmup, the rollout and the second model included
        "launches": {k: sum(h["kernel_launches"][k] for h in health.values())
                     for k in health[0]["kernel_launches"]},
    }
    emit(result)
    shutil.rmtree(run["work"], ignore_errors=True)
    return result


FAULTS_PLAN = "corpus-read:1:oserror,checkpoint-write:1:oserror,step:7:nan"
FAULTS_WATCHDOG_S = 15  # train:faults: [training] watchdog_timeout_s
FAULTS_STEPS, FAULTS_EVAL = 40, 10
FAULTS_HANG_AT = 15     # the callback hangs before the 16th step, after the step-10 generation
FAULTS_RETRY_BASE_S = 0.05  # the retries' backoff base (the default 0.5 s only waits)
FAULTS_DRILL = """
import atexit
import json
import os
import time
from pathlib import Path

from spacy_ray_tpu_torch.ops import _cuda
from spacy_ray_tpu_torch.registry import registry


@registry.callbacks("chip_smoke.hang_once.v1")
def hang_once(marker: str, at_step: int, seconds: float, launches: str):
    # this process's launch counts, at every step and at exit
    out = Path(launches) / f"{os.getpid()}.json"

    def write():
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(_cuda.launch_counts()))

    atexit.register(write)

    def hang_in_before_update(nlp, info):
        write()
        if info["step"] == at_step and not Path(marker).exists():
            Path(marker).write_text(str(time.time()))
            time.sleep(seconds)

    return hang_in_before_update
"""


def start_train_faults(corpus) -> dict:
    """train:faults started: ``train configs/cnn.cfg --max-restarts 1
    --metrics-dir`` with the fault plan :data:`FAULTS_PLAN`, the watchdog at
    :data:`FAULTS_WATCHDOG_S` and a ``--code`` callback that hangs twice that
    once, as a subprocess; reader threads stamp its lines.
    :func:`phase_train_faults` reads it."""
    import os

    work = WORK / "train_faults"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    code = work / "drill.py"
    code.write_text(FAULTS_DRILL, encoding="utf8")
    hang = {"@callbacks": "chip_smoke.hang_once.v1", "marker": str(work / "hung"),
            "at_step": FAULTS_HANG_AT, "seconds": 2 * FAULTS_WATCHDOG_S,
            "launches": str(work / "launches")}
    log = {"@loggers": "spacy_ray_tpu.JsonlLogger.v1", "path": str(work / "train_log.jsonl")}
    run = {"work": work, "out": work / "out", "metrics": work / "metrics", "lines": [],
           "t0": time.perf_counter()}
    run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "train", "configs/cnn.cfg",
         "--device", "cuda", "--max-restarts", "1", "--output", str(run["out"]),
         "--metrics-dir", str(run["metrics"]), "--code", str(code),
         "--paths.train", str(corpus[0]), "--paths.dev", str(corpus[1]),
         "--training.watchdog_timeout_s", str(FAULTS_WATCHDOG_S),
         "--training.io_retry_base_s", str(FAULTS_RETRY_BASE_S),
         "--training.eval_frequency", str(FAULTS_EVAL),
         "--training.max_steps", str(FAULTS_STEPS),
         "--training.before_update", json.dumps(hang), "--training.logger", json.dumps(log)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT), "SPACY_RAY_TPU_FAULT_PLAN": FAULTS_PLAN},
        start_new_session=True)

    def read(stream, name):
        for line in stream:
            run["lines"].append((time.perf_counter() - run["t0"], name, line.rstrip()))

    run["readers"] = [threading.Thread(target=read, args=(run["proc"].stdout, "out"),
                                       daemon=True),
                      threading.Thread(target=read, args=(run["proc"].stderr, "err"),
                                       daemon=True)]
    for t in run["readers"]:
        t.start()
    return run


def phase_train_faults(run) -> dict:
    """train:faults (:func:`start_train_faults`) read: fails unless the run
    ended 0 with a ``last-model/`` after exactly one restart of a child that
    exited 79 with a thread dump naming the hanging callback; each attempt
    retried its corpus open and its first generation's write; the
    evaluations after each attempt's poisoned step report a non-finite
    ``loss_total`` and a ``nan-loss`` anomaly (``metrics.jsonl``, the
    ``JsonlLogger.v1`` rows); the resumed attempt logged its resume from
    step 10; and K1 fwd, K1 bwd and K5 launched in both attempts."""
    import os
    import signal

    phase, proc = "train:faults", run["proc"]
    try:
        rc = proc.wait(timeout=600)
        for t in run["readers"]:
            t.join(timeout=10)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    lines = run["lines"]
    err = "\n".join(text for _, name, text in lines if name == "err")

    def first(pred):
        return next((t for t, _, text in lines if pred(text)), None)

    fired = first(lambda x: x.startswith("[watchdog] no step heartbeat"))
    restarted = first(lambda x: "[supervisor-restart] child exited rc=79" in x)
    done = first(lambda x: x.startswith("Done. steps="))
    # each attempt's first corpus open (its imports and device done) and its
    # evaluation of the poisoned step
    opened = [t for t, _, x in lines if "[fault-injected] corpus-read call 1" in x]
    nan_evals = [t for t, _, x in lines if "[nan-loss]" in x]
    rows = [json.loads(x) for x in open(run["metrics"] / "metrics.jsonl", encoding="utf8")]
    evals = [(r["step"], r["loss_total"]) for r in rows if r["kind"] == "eval"]
    anomalies = [(r["anomaly"], r["step"]) for r in rows if r["kind"] == "anomaly"]
    log = [json.loads(x) for x in open(run["work"] / "train_log.jsonl", encoding="utf8")]
    logged = [(e["event"], e.get("step")) for r in log for e in r.get("events", [])]
    attempts = [json.loads(f.read_text()) for f in sorted((run["work"] / "launches")
                                                           .glob("*.json"))]
    need = ("hash_embed_gather_sum", "hash_embed_table_grad", "fused_update")
    retries = {site: err.count(f"[io-retry] {site}:") for site in ("corpus-read",
                                                                    "checkpoint-write")}
    want_evals = [(10, "nan"), (20, "nan"), (30, None), (40, None)]
    bad = []
    if rc != 0 or done is None or not (run["out"] / "last-model" / "params.npz").exists():
        bad.append(f"exit {rc}, done {done}")
    if err.count("[supervisor-restart] child exited rc=79") != 1 or fired is None:
        bad.append("no single watchdog exit 79 and restart")
    if "hang_in_before_update" not in err:
        bad.append("the thread dump does not name the callback")
    if retries != {"corpus-read": 2, "checkpoint-write": 2}:
        bad.append(f"retries {retries}")
    if [s for s, _ in evals] != [w for w, _ in want_evals] or \
            [v == "nan" for _, v in evals] != [w == "nan" for _, w in want_evals]:
        bad.append(f"eval rows (step, loss_total) {evals}")
    # (a step-time regression may fire too: the drill shares the card and the
    # host with the phases beside it)
    if [a for a in anomalies if a[0] == "nan-loss"] != [("nan-loss", 10), ("nan-loss", 20)]:
        bad.append(f"anomalies {anomalies}")
    if [e for e in logged if e[0] in ("nan-loss", "resume")] != [
            ("nan-loss", 10), ("resume", 10), ("nan-loss", 20)]:
        bad.append(f"JsonlLogger events {logged}")
    if len(attempts) != 2 or not all(a[k] > 0 for a in attempts for k in need):
        bad.append(f"launches by attempt {attempts}")
    if bad:
        fail(f"{phase}: " + "; ".join(bad) + "\n" + "\n".join(
            text for _, _, text in lines if not text.startswith(("  File", "    ")))[-6000:])
    launches = {k: sum(a[k] for a in attempts) for k in attempts[0]}
    result = {
        "phase": phase, "exit": rc, "seconds": done, "corpus_opened_s": opened,
        "nan_eval_s": nan_evals,
        "watchdog_fired_s": fired, "restart_s": restarted, "resumed_run_end_s": done,
        "restart_to_end_s": done - restarted, "evals_step_loss_total": evals,
        "anomalies": anomalies, "retries": retries, "jsonl_events": logged,
        "launches_by_attempt": attempts, "launches": launches,
        "steps_rows": sum(1 for r in rows if r["kind"] == "step"),
    }
    emit(result)
    shutil.rmtree(run["work"], ignore_errors=True)
    return result


TNS_EVERY = 10          # cli:train_and_serve: a generation (an evaluation) every 10 steps
TNS_MAX_STEPS = 20000   # a cap the SIGTERM comes far before
TNS_KEEP = 20           # generations kept: the newest outlives its rollout
TNS_DEV_DOCS = 16       # the evaluations' dev docs


def start_train_and_serve(corpus) -> dict:
    """cli:train_and_serve started: ``python -m spacy_ray_tpu_torch
    train-and-serve configs/cnn.cfg --output <dir> --replicas 1 --port 0``
    (its ``--train-arg``s: the corpora, a generation every ``TNS_EVERY``
    steps) as a subprocess in its own session, and a thread that waits for
    its fleet, sends one client's requests until their answers carry two
    generations (the controller's direct rollout of a newer one between
    two requests), and then sends the one SIGTERM. :func:`phase_train_and_serve`
    reads it."""
    import os
    import signal

    from spacy_ray_tpu_torch.training.corpus import Corpus
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin

    work = WORK / "train_and_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = work / "dev.spacy"
    egs = list(Corpus(corpus[1])())
    write_docbin(dev, [eg.reference for eg in egs][:TNS_DEV_DOCS])
    texts = [" ".join(eg.reference.words) for eg in egs if len(eg.reference.words) <= 100]
    # patience 0: no early stop, so the trainer is still running at the SIGTERM
    train_args = ["--paths.train", str(corpus[0]), "--paths.dev", str(dev),
                  "--training.max_steps", str(TNS_MAX_STEPS), "--training.patience", "0",
                  "--training.eval_frequency", str(TNS_EVERY),
                  "--training.keep_checkpoints", str(TNS_KEEP)]
    run = {"work": work, "out": work / "out", "lines": [], "marks": {}, "rows": [],
           "t0": time.perf_counter()}
    run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "train-and-serve", "configs/cnn.cfg",
         "--output", str(run["out"]), "--replicas", "1", "--port", "0", "--max-batch", "8",
         "--max-doc-len", "128", "--watch-interval-s", "0.5",
         *(f"--train-arg={a}" for a in train_args)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, start_new_session=True)
    proc, lines, marks = run["proc"], run["lines"], run["marks"]

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            for key in ("bootstrapped serving model", "fleet ready: 1", "[train] Interrupted",
                        "train-and-serve drained"):
                if line.startswith(key):
                    marks.setdefault(key, time.perf_counter() - run["t0"])

    def drive():
        rng = random.Random(4)
        try:
            while "fleet ready: 1" not in marks:
                if proc.poll() is not None or time.perf_counter() - run["t0"] > 300:
                    banner = [l for l in lines if l.startswith("train-and-serve fleet on ")]
                    if banner:  # what the router saw of its replica, and the replica itself
                        port = banner[0].split("http://", 1)[1].split()[0].rsplit(":", 1)[1]
                        rows = get(int(port), "/metrics")[1]["replicas"]
                        run["error"] = f"not ready: {rows}; " + "; ".join(
                            replica_state(r) for r in rows)
                    return
                time.sleep(0.05)
            banner = [l for l in lines if l.startswith("train-and-serve fleet on http://")]
            port = int(banner[0].split("http://", 1)[1].split()[0].rsplit(":", 1)[1])
            run["port"] = port
            roster = get(port, "/metrics")[1]["replicas"]
            run["pids"] = [r["pid"] for r in roster]
            while time.perf_counter() - run["t0"] < 420:
                body = [rng.choice(texts) for _ in range(2)]
                t = time.perf_counter()
                status, raw, sec = fleet_request(port, body, f"tns-{len(run['rows'])}")
                gen = json.loads(raw)["batch"].get("generation") if status == 200 else None
                run["rows"].append((status, gen, t - run["t0"], sec))
                seen = {g for _, g, _, _ in run["rows"] if g is not None}
                if len(seen) >= 2:  # a flip between two of the client's requests
                    marks["flip"] = t - run["t0"]
                if status != 200 or len(seen) >= 2:
                    break
            run["health"] = get(roster[0]["port"], "/healthz")[1]
        except (OSError, ValueError, KeyError, IndexError) as e:
            run["error"] = repr(e)
        finally:
            marks["sigterm"] = time.perf_counter() - run["t0"]
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:  # the exit's own time: the phase reads it after train:fleet_async
                proc.wait(timeout=300)
                marks["exit"] = time.perf_counter() - run["t0"]
            except subprocess.TimeoutExpired:
                pass

    run["reader"] = threading.Thread(target=read, daemon=True)
    run["driver"] = threading.Thread(target=drive, daemon=True)
    run["reader"].start()
    run["driver"].start()
    return run


def phase_train_and_serve(run) -> dict:
    """cli:train_and_serve (:func:`start_train_and_serve`) read: fails
    unless the client saw a generation swapped into the replica with no
    failed request, and the one SIGTERM ended the tree with exit 0, the
    fleet's drain clean and the trainer's exit 75 after a step-boundary
    generation, with none of its processes left."""
    import os
    import signal

    from spacy_ray_tpu_torch.training.checkpoint import Checkpoints

    phase, proc, lines, marks = "cli:train_and_serve", run["proc"], run["lines"], run["marks"]
    try:
        run["driver"].join(timeout=600)
        rc = proc.wait(timeout=300)
        run["reader"].join(timeout=10)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    trainer = [int(l.split("training pid ", 1)[1].split()[0]) for l in lines
               if "train-and-serve: training pid " in l]
    left = [p for p in trainer + run.get("pids", []) if not proc_gone(p)]
    interrupted = [l for l in lines if l.startswith("[train] Interrupted at step ")]
    step = int(interrupted[-1].split("step ", 1)[1].split()[0]) if interrupted else None
    gens = Checkpoints(run["out"] / "last-model").generations()
    failed = [r for r in run["rows"] if r[0] != 200]
    drained = "train-and-serve drained (fleet rc 0, trainer rc 75 = preempted-clean)"
    if rc != 0 or failed or "flip" not in marks or "exit" not in marks or left or \
            drained not in lines or step is None or step not in gens or "error" in run:
        fail(f"{phase}: exit {rc}, failed requests {failed[:5]}, marks {marks}, left {left}, "
             f"interrupted at {step}, generations {gens[-3:]}, {run.get('error')}:\n"
             + "\n".join([l for l in lines if not l.startswith("[train] ")][-40:]
                          + lines[-5:]))
    health = run["health"]
    result = {
        "phase": phase, "seconds": marks["exit"],
        "to_bootstrap_s": marks["bootstrapped serving model"],
        "to_ready_s": marks["fleet ready: 1"], "ready_to_flip_s": marks["flip"] - marks[
            "fleet ready: 1"], "drain_s": marks["exit"] - marks["sigterm"],
        "sigterm_to_trainer_exit_line_s": marks["[train] Interrupted"] - marks["sigterm"],
        "sigterm_to_drained_line_s": marks["train-and-serve drained"] - marks["sigterm"],
        "requests": len(run["rows"]), "no_failed_request": True,
        "served_generations": sorted({g for _, g, _, _ in run["rows"] if g is not None}),
        "trainer_interrupted_at": step,
        "generations_kept": len(gens), "exit": rc, "trainer_exit": 75,
        "replica_peak_memory_bytes": health.get("peak_memory_bytes"),
        # the replica's; the trainer's launches (K1 fwd, K1 bwd, K5) stay in its process
        "launches": health["kernel_launches"],
    }
    emit(result)
    shutil.rmtree(run["work"], ignore_errors=True)
    return result


def slo_window(port: int):
    """A replica's latency window, the one the canary guard reads: (samples,
    p99 seconds or None)."""
    win = get(port, "/metrics")[1].get("slo_window") or {}
    return win.get("samples", 0), win.get("request_latency_p99")


def fleet_rollout(phase, run, port, ports, texts, gens, cache0, cpu_gen, cpu_gen_by_text):
    """serve:fleet's rollout: once neither replica's latency window holds a
    request from before it, under :class:`FleetLoad`'s clients, generation
    ``gens["stamp"]`` published into the watched directory; fails unless the
    controller canaries it on replica 1 (the youngest), the router splits,
    the guard (its p99 bound at the default) promotes and both replicas flip
    to it within ``FLEET_ROLLOUT_S``, the cache is flushed at the promotion,
    no request fails, and the answers stamped with it agree with its params
    on the CPU on >= 0.99 of tokens."""
    from spacy_ray_tpu_torch.serving.engine import SERVING_DEFAULTS
    from spacy_ray_tpu_torch.serving.fleet import FleetConfig

    lines, stamp = run["lines"], gens["stamp"]
    # the guard compares the canary's window p99 with the baseline's; replica
    # 1 served the kill's half and the paired requests alone, so both windows
    # are let empty first and then hold the rollout's traffic only
    t_quiet = time.perf_counter()
    while any(slo_window(p)[0] for p in ports.values()):
        if time.perf_counter() - t_quiet > SERVING_DEFAULTS["slo_window_s"] + 30:
            fail(f"{phase}: the replicas' latency windows never emptied: "
                 f"{ {rid: slo_window(p) for rid, p in ports.items()} }")
        time.sleep(0.25)
    quiet_s = time.perf_counter() - t_quiet
    windows, t_windows = None, 0.0
    with FleetLoad(port, texts, tag="rollout") as load:
        time.sleep(0.5)  # traffic on the first generation
        t_pub = publish_generation(gens["dir"], stamp, run["watch"], stamp)
        t0 = time.perf_counter()
        while True:
            on = {rid: get(p, "/healthz")[1].get("generation") for rid, p in ports.items()}
            if all(g == stamp for g in on.values()):
                break
            # the canary's verdict pending: the windows it reads, once a
            # guard tick (a snapshot costs the replica more than /healthz)
            if on[1] == stamp and time.perf_counter() - t_windows >= FLEET_WATCH_INTERVAL_S:
                windows = {rid: slo_window(p) for rid, p in sorted(ports.items())}
                t_windows = time.perf_counter()
            if any("[canary-rollback]" in l or "[live-rollback]" in l for l in lines) or \
                    time.perf_counter() - t0 > FLEET_ROLLOUT_S:
                fail(f"{phase}: generation {stamp} not promoted on both replicas (the "
                     f"windows last read {windows}):\n" + "\n".join(lines[-30:]))
            time.sleep(0.05)
        rollout_s = time.perf_counter() - t0
        time.sleep(0.5)  # answers after the promotion
    failed = load.failed()
    if failed:
        fail(f"{phase}: {len(failed)} requests failed across the rollout: {failed[:5]}")
    flips = {rid: flip_unix(p, stamp) for rid, p in ports.items()}
    if None in flips.values() or not flips[1] < flips[0]:
        fail(f"{phase}: the flips of generation {stamp} by replica: {flips}")
    said = [l for l in lines if f"generation {stamp} canarying on replica(s) [1]" in l
            or f"generation {stamp} promoted fleet-wide" in l]
    _, metrics = get(port, "/metrics")
    router, cache = metrics["router"]["counters"], metrics["cache"]
    if len(said) != 2 or not router.get("routed_canary") or \
            not cache["cache_flushes"] > cache0["cache_flushes"]:
        fail(f"{phase}: the controller said {said}, the router {router}, the cache {cache}")
    got, want = load.answered(None, stamp)
    agree = agreement(cpu_gen, got, [cpu_gen_by_text[t] for t in want])
    if not got or min(agree.values()) < 0.99:
        fail(f"{phase}: generation {stamp}'s answers agree with its params on the CPU only "
             f"{agree} ({len(got)} docs)")
    sent = sorted(sec for *_, sec in load.rows)
    p99 = {rid: w[1] for rid, w in (windows or {}).items()}
    return {"windows_empty_after_s": quiet_s, "guard_p99_frac": FleetConfig.guard_p99_frac,
            "guard_min_samples": FLEET_GUARD_MIN_SAMPLES,
            "windows_before_promotion": {
                str(rid): {"samples": n, "p99_ms": None if q is None else q * 1e3}
                for rid, (n, q) in (windows or {}).items()},
            "canary_over_baseline_p99": p99[1] / p99[0] if p99.get(0) and p99.get(1) else None,
            "generation": stamp, "publish_to_canary_flip_s": flips[1] - t_pub,
            "publish_to_promotion_flip_s": flips[0] - t_pub,
            "publish_to_both_healthz_s": rollout_s, "requests": len(load.rows),
            "no_failed_request": True, "routed_canary": router["routed_canary"],
            "routed_baseline": router.get("routed_baseline", 0),
            "cache_flushes": cache["cache_flushes"] - cache0["cache_flushes"],
            "docs_stamped": len(got), "card_vs_cpu_at_generation": agree,
            "p50_ms": percentile(sent, 0.5) * 1e3, "p99_ms": percentile(sent, 0.99) * 1e3}


def fleet_refusal_and_placement(phase, run, port, ports, texts, gens, cpu, cpu_by_text, cpu_gen,
                                cpu_gen_by_text):
    """serve:fleet after the rollout, under one :class:`FleetLoad` whose
    requests alternate the default model and "hot": (1) a generation of
    another pipeline published above the first stamp; each replica's
    ``/admin/swap`` to it answers 409, the controller refuses it once, and
    both replicas stay on the first stamp for ``FLEET_HOLD_S`` more; (2)
    "hot", loaded on replica 1 while replica 0 restarted, its traffic routed
    there until the placement tick loads it onto replica 0 within
    ``FLEET_PLACE_S``
    (``placement_decisions`` counted, "hot" resident on both, its answers
    the base model's on the CPU); (3) ``telemetry collect-trace`` on the
    router's URL merging three processes' traces. No request fails."""
    import os

    from spacy_ray_tpu_torch.training.checkpoint import Checkpoints

    lines, stamp, watch = run["lines"], gens["stamp"], run["watch"]
    mis = stamp + FLEET_MISMATCH_OFFSET
    t0 = time.perf_counter()
    while get(port, "/metrics")[1].get("placement") != {"0": ["cnn"], "1": ["cnn", "hot"]}:
        if time.perf_counter() - t0 > 30:
            fail(f"{phase}: the router never saw 'hot' on replica 1 alone: "
                 f"{get(port, '/metrics')[1].get('placement')}")
        time.sleep(0.05)
    decisions0 = get(port, "/metrics")[1]["router"]["counters"].get("placement_decisions", 0)
    merged = run["work"] / "fleet_trace.json"
    collector = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "telemetry", "collect-trace",
         f"http://127.0.0.1:{port}", "--out", str(merged)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        with FleetLoad(port, texts, models=(None, "hot"), seed=3, tag="place") as load:
            t_load = time.perf_counter()
            src = gens["mismatch"]
            publish_generation(src, max(Checkpoints(src).generations()), watch, mis)
            direct = {rid: post_status(p, "/admin/swap", {"dir": str(watch), "generation": mis})
                      for rid, p in sorted(ports.items())}
            refused = f"replica 1 refused swap to generation {mis}: HTTP 409"
            placed, t_placed = None, None
            while time.perf_counter() - t_load < FLEET_PLACE_S:
                if placed is None and "hot" in get(ports[0], "/healthz")[1].get(
                        "resident_models", {}):
                    placed, t_placed = True, time.perf_counter() - t_load
                if placed and any(refused in l for l in lines):
                    break
                time.sleep(0.05)
            time.sleep(FLEET_HOLD_S)
        out, err = collector.communicate(timeout=120)
    finally:
        if collector.poll() is None:
            collector.kill()
            collector.wait()
    failed = load.failed()
    gens_now = {rid: get(p, "/healthz")[1] for rid, p in sorted(ports.items())}
    refusals = [l for l in lines if refused in l]
    problems = []
    if failed:
        problems.append(f"{len(failed)} requests failed: {failed[:5]}")
    if set(direct.values()) != {409} or len(refusals) != 1 or \
            any(h["generation"] != stamp for h in gens_now.values()):
        problems.append(f"the mismatched generation {mis}: direct swaps {direct}, the "
                        f"controller's refusals {refusals}, replicas on "
                        f"{[h['generation'] for h in gens_now.values()]}")
    decisions = get(port, "/metrics")[1]["router"]["counters"].get("placement_decisions", 0)
    moved = [l for l in lines if "[placement-move] model 'hot' -> replica 0 (status 200)" in l]
    if not placed or decisions <= decisions0 or not moved or \
            not all("hot" in h.get("resident_models", {}) for h in gens_now.values()):
        problems.append(f"placement: hot on replica 0 {placed}, decisions {decisions0} -> "
                        f"{decisions}, said {moved}")
    agree = {}
    for model, ref, by_text, gen in ((None, cpu_gen, cpu_gen_by_text, stamp),
                                     ("hot", cpu, cpu_by_text, None)):
        got, want = load.answered(model, gen)
        agree[model or "cnn"] = a = agreement(ref, got, [by_text[t] for t in want])
        if not got or min(a.values()) < 0.99:
            problems.append(f"{model or 'cnn'} answers vs the CPU {a} ({len(got)} docs)")
    match = re.search(r"merged (\d+) event\(s\) from (\d+) process\(es\)", out)
    tracks = []
    if collector.returncode == 0 and merged.exists():
        tracks = sorted((e["pid"], e["args"]["name"].split()[0])
                        for e in json.loads(merged.read_text())["traceEvents"]
                        if e.get("name") == "process_name")
    if not match or match.group(2) != "3" or \
            tracks != [(0, "router"), (1, "replica-0"), (2, "replica-1")]:
        problems.append(f"collect-trace exited {collector.returncode}: {out!r} {err[-500:]!r}, "
                        f"tracks {tracks}")
    if problems:
        fail(f"{phase}: " + "; ".join(problems) + "\n" + "\n".join(lines[-20:]))
    return {"mismatch": {"generation": mis, "direct_swaps": direct, "controller_refusals": 1,
                         "fleet_stayed_on": stamp},
            "placement": {"decisions": decisions - decisions0, "seconds_to_move": t_placed,
                          "hot_requests": sum(1 for r in load.rows if r[0] == "hot"),
                          "resident": {rid: sorted(h["resident_models"])
                                       for rid, h in gens_now.items()}},
            "collect_trace": {"events": int(match.group(1)), "processes": 3,
                              "tracks": [name for _, name in tracks]},
            "drills_requests": len(load.rows), "drills_card_vs_cpu": agree}


def phase_cli(model_dir: Path):
    """The command a user runs, as a subprocess, answering one request."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve", str(model_dir),
         "--port", "0", "--max-batch", "2", "--max-doc-len", "32"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    ready = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "ready" in line:
                ready.set()
        ready.set()

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        ready.wait(timeout=240)
        ports = [int(l.rsplit(":", 1)[1]) for l in lines if l.startswith("serving on http://")]
        if not ports or proc.poll() is not None:
            fail("serve CLI did not come up:\n" + "\n".join(lines))
        status, body = post(ports[0], ["The old man came back from Paris ."])
        _, health = get(ports[0], "/healthz")
        if status != 200 or not body["docs"][0].get("tags"):
            fail(f"serve CLI answered {status}: {body}")
        if health["kernel_launches"]["flash_attention_fwd"] == 0:
            fail(f"serve CLI ran no attention kernel: {health}")
        proc.terminate()
        rc = proc.wait(timeout=60)
        th.join(timeout=10)
        emit({"phase": "cli", "output": lines, "status": status, "exit": rc,
              "kernel_launches": health["kernel_launches"]})
        if rc != 0:
            fail(f"serve CLI exited {rc} after SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def serve_once(torch, model_dir: Path):
    """``model_dir`` through the serving entry point for one request."""
    from spacy_ray_tpu_torch.__main__ import build_server

    server = build_server([str(model_dir), "--port", "0", "--max-batch", "2",
                           "--max-doc-len", "128"])
    engine = server.engine
    try:
        _, port = server.start()
        engine.start()
        status, body = post(port, ["the dog sees a green tree in Tokyo"])
        tags = body["docs"][0].get("tags") if status == 200 else None
        if not tags:
            fail(f"best-model did not serve: {status} {body}")
        server.request_shutdown()
        if server.wait() != 0:
            fail("serving best-model did not drain cleanly")
        return {"status": status, "tags": tags}
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine
        torch.cuda.empty_cache()


def phase_train(torch):
    """``train()`` at trf.cfg's full width (depth ``TRF_CUT_DEPTH``) on a
    synthetic tagged corpus, with the launch counters zeroed just before
    and read just after."""
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length
    from spacy_ray_tpu_torch.training.loop import train
    from spacy_ray_tpu_torch.util import write_synth_jsonl

    work = WORK / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    write_synth_jsonl(work / "train.jsonl", 2000, seed=0, min_len=8, max_len=120)
    write_synth_jsonl(work / "dev.jsonl", 200, seed=1, min_len=8, max_len=120)
    cfg = trf_tagger_config()
    cfg["components"]["transformer"]["model"]["depth"] = TRF_CUT_DEPTH
    cfg["paths"] = {"train": str(work / "train.jsonl"), "dev": str(work / "dev.jsonl")}
    cfg["training"]["max_steps"] = TRAIN_STEPS
    cfg["training"]["eval_frequency"] = TRAIN_EVAL
    out = work / "out"

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    nlp, result = train(cfg, out, device="cuda", stdout_log=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = result.step_losses
    need = ["hash_embed_gather_sum", "hash_embed_table_grad", "flash_attention_fwd",
            "flash_attention_bwd", "fused_update"]
    missing = [k for k in need if launches[k] == 0]
    if missing:
        fail(f"train: kernels never launched on the training path: {missing}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"train: {len(losses)} step losses, expected {TRAIN_STEPS} finite ones")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        fail(f"train: the loss did not fall (first 5 steps {first}, last 5 {last})")
    event_ms = [a.elapsed_time(b) for a, b in result.step_events]
    host_ms = [x * 1e3 for x in result.step_host_seconds]

    # one step split into forward, backward and optimizer: device time by
    # CUDA events, host time to enqueue each part (from an idle card)
    cfg_i = cfg.interpolate()
    nlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}
    optimizer = registry.resolve(cfg_i["training"]["optimizer"])
    opt_state = optimizer.init(params)
    corpus = registry.resolve(cfg_i["corpora"]["train"])
    batcher = registry.resolve(cfg_i["training"]["batcher"])
    batches = []
    for b in batcher(corpus()):
        batches.append(b)
        if len(batches) == 4:
            break
    B_pad = bucket_batch_size(max(len(b) for b in batches))
    T_pad = bucket_length(max(len(eg) for b in batches for eg in b))
    collated = [nlp.collate(b, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
                for b in batches]

    def timed(fn):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        host = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1), host

    parts = {"forward": [0.0, 0.0], "backward": [0.0, 0.0], "optimizer": [0.0, 0.0]}
    for rep in range(3):
        for p in params.values():
            p.grad = None if rep == 0 else p.grad.zero_()
        for c in collated[:3]:
            (loss, _), dev_ms, h = timed(lambda: nlp.loss(c["tokens"], c["targets"],
                                                          dropout=0.1, seed=rep))
            if rep:
                parts["forward"][0] += dev_ms / 2
                parts["forward"][1] += h / 2
            _, dev_ms, h = timed(loss.backward)
            if rep:
                parts["backward"][0] += dev_ms / 2
                parts["backward"][1] += h / 2
        grads = {k: p.grad for k, p in params.items()}
        torch._foreach_div_(list(grads.values()), 3.0)
        with torch.no_grad():
            _, dev_ms, h = timed(lambda: optimizer.update(params, grads, opt_state))
        if rep:
            parts["optimizer"][0] += dev_ms / 2
            parts["optimizer"][1] += h / 2

    # one whole step under torch.profiler: device time by kernel, and the
    # share of the step's wall time the card spent idle
    from torch.profiler import ProfilerActivity, profile

    def one_step():
        for p in params.values():
            p.grad.zero_()
        for c in collated[:3]:
            nlp.loss(c["tokens"], c["targets"], dropout=0.1, seed=7)[0].backward()
        grads = {k: p.grad for k, p in params.items()}
        torch._foreach_div_(list(grads.values()), 3.0)
        with torch.no_grad():
            optimizer.update(params, grads, opt_state)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        step_wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    # the attention kernels' device time in the step, by kernel (K2: forward
    # and remat recompute; K3: its two passes)
    attention_ms = {name: sum(dev_us(e) for e in events if name in e.key) / 1e3
                    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    attention_calls = {name: sum(e.count for e in events if name in e.key)
                       for name in attention_ms}
    # the table gradient's kernels (first design: table_grad_vec4; now
    # table_grad_pieces and table_grad_spans), its sort apart
    table_grad = [e for e in events if "table_grad" in e.key]
    update = [e for e in events if "fused_update" in e.key]
    gather = [e for e in events if "gather_sum" in e.key]
    top = sorted(events, key=dev_us, reverse=True)[:15]
    host_ops = sorted((e for e in prof.key_averages()
                       if not str(getattr(e, "device_type", "")).endswith("CUDA")),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    profile_row = {
        "step_wall_ms": step_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_wall_ms,
        "attention_kernels_ms": attention_ms, "attention_kernel_calls": attention_calls,
        "table_grad_kernels_ms": sum(dev_us(e) for e in table_grad) / 1e3,
        "table_grad_kernel_calls": sum(e.count for e in table_grad),
        "table_grad_share_of_busy": sum(dev_us(e) for e in table_grad) / 1e3 / busy_ms,
        "fused_update_kernel_ms": sum(dev_us(e) for e in update) / 1e3,
        "gather_sum_kernels_ms": sum(dev_us(e) for e in gather) / 1e3,
        "gather_sum_kernel_calls": sum(e.count for e in gather),
        "top_device_ms": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in top],
        "top_host_self_ms": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                             for e in host_ops],
    }

    # the gradients of one microbatch with every kernel and with every kernel
    # swapped for its plain version, dropout off
    rel = grad_errs_vs_plain(torch, nlp, params, collated[3])
    worst_leaf = max(rel, key=rel.get)
    if not rel[worst_leaf] <= TOL_GRAD:
        fail(f"train: gradient of {worst_leaf} kernels vs plain {rel[worst_leaf]} > {TOL_GRAD}")
    nlp.model.requires_grad_(False)
    del nlp, params, optimizer, opt_state, grads, collated
    torch.cuda.empty_cache()

    served = serve_once(torch, out / "best-model")
    res = {
        "phase": "train:trf", "depth": TRF_CUT_DEPTH, "seconds": seconds,
        "steps": result.final_step,
        "accumulate_gradient": 3, "group_shapes_B_T": sorted(set(result.step_shapes)),
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_first5_mean": first, "loss_last5_mean": last,
        "dev_tag_acc": [(h["step"], h["other_scores"].get("tag_acc")) for h in result.history],
        "step_ms_median_events": statistics.median(event_ms),
        "step_ms_median_host": statistics.median(host_ms),
        "words_per_s": result.wps, "words": result.words_seen,
        "peak_memory_gb": peak_gb, "launches": launches,
        "step_split_ms_device_host": {k: v for k, v in parts.items()},
        # device work still queued when the host has enqueued the backward
        "backward_device_tail_ms": parts["backward"][0] - parts["backward"][1],
        "step_split_B_T": [B_pad, T_pad], "step_profile": profile_row,
        # kernel time (under the profiler) against the unprofiled step's time
        "device_idle_share_of_step": 1.0 - profile_row["device_busy_ms"]
        / statistics.median(event_ms),
        "grad_max_rel_err": rel[worst_leaf], "grad_worst_leaf": worst_leaf,
        "grad_tol": TOL_GRAD, "best_model_served_tags": served["tags"],
    }
    emit(res)
    return res


def entity_set(actions, lengths, labels):
    """{(row, start, end, label)} of BILUO action ids [B, T]."""
    from spacy_ray_tpu_torch.pipeline.components.ner import action_to_biluo
    from spacy_ray_tpu_torch.pipeline.doc import Doc

    acts = actions.cpu().tolist()
    out = set()
    for i, n in enumerate(lengths):
        tags = [action_to_biluo(a, labels) for a in acts[i][:n]]
        out.update((i, s.start, s.end, s.label) for s in Doc.spans_from_biluo(tags))
    return out


def set_f(a, b) -> float:
    return 1.0 if not a and not b else 2 * len(a & b) / (len(a) + len(b))


def trf_step_flops(B: int, T: int, n_tags: int, n_micro: int, *, width: int = 768,
                   depth: int = 12, ffn: int = 3072) -> float:
    """The analytic FLOPs of a trf.cfg training step's trunk and tagger (the
    parser's and NER's products left out): per microbatch of B x T padded
    tokens, the embeddings' Maxout mix (4 tables' concat -> 3 pieces) and the
    tagger's output layer at forward + backward (3 x), each layer's four
    weight products at 4 x (forward, remat's second forward, backward) and
    its attention, scores and p @ v over every key, at 2 x 2 forward + 5
    products backward."""
    N = B * T
    mix = 2 * N * (4 * width) * (3 * width)
    layer = 2 * N * (width * 3 * width + width * width + 2 * width * ffn)
    attention = 2 * B * T * T * width
    return float(n_micro * (3 * mix + depth * (4 * layer + 2 * 2 * attention + 5 * attention)
                            + 3 * 2 * N * width * n_tags))


class TelemetryScraper:
    """A thread that scrapes a trainer's telemetry endpoint while it trains:
    ``/healthz``, ``/metrics`` (JSON and Prometheus text), and, from the
    ``collect_from``-th step on, ``telemetry collect-trace``'s merge of its
    ``/trace`` (the last merge kept: the endpoint goes with the run)."""

    def __init__(self, port: int, collect_from: int):
        self.port, self.collect_from = port, collect_from
        self.got = {"healthz": 0, "metrics": 0, "prometheus": 0, "errors": 0}
        self.health = self.prometheus = self.merged = None
        self.max_steps_seen = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="smoke-scraper")

    def _run(self) -> None:
        from spacy_ray_tpu_torch.serving.tracecollect import collect_fleet_traces

        url = f"http://127.0.0.1:{self.port}"
        while not self._stop.wait(SCRAPE_EVERY_S):
            try:
                self.health = get(self.port, "/healthz")[1]
                self.got["healthz"] += 1
                snap = get(self.port, "/metrics")[1]
                self.got["metrics"] += 1
                with urllib.request.urlopen(url + "/metrics?format=prometheus", timeout=30) as r:
                    self.prometheus = r.read().decode()
                self.got["prometheus"] += 1
                steps = int(snap["counters"]["steps"])
                self.max_steps_seen = max(self.max_steps_seen, steps)
                if steps >= self.collect_from:
                    merged = collect_fleet_traces([url])
                    if merged["otherData"].get("merged_from"):
                        self.merged = merged
            except (OSError, ValueError, KeyError):
                self.got["errors"] += 1

    def __enter__(self) -> "TelemetryScraper":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=60)


FULL_TRACE_STEPS = [5, 15]  # train:full: the steps whose spans the trace keeps
SCRAPE_EVERY_S = 1.0        # train:full: the endpoint's scrapes (each takes the trainer's GIL)


def step_boundary_host_us(work: Path, calls: int = 2000) -> dict:
    """The host's cost of ``Telemetry.step_boundary``, the one call telemetry
    adds to a step: ``calls`` calls on a facade of its own (a step's stamp, the
    histogram, the buffered row, the detector, a span inside the trace
    window for the first half), median and p99 of single calls, in us. Its
    clock moves 0.5 s a call, so every step reads alike to the detector."""
    from spacy_ray_tpu_torch.training.telemetry import Telemetry

    ticks = itertools.count()
    tel = Telemetry(work / "step_boundary_cost", trace_steps=(0, calls // 2),
                    clock=lambda: 0.5 * next(ticks))
    tel.loop_start()
    us = []
    for i in range(1, calls + 1):
        t = time.perf_counter()
        tel.step_boundary(step=i, epoch=0, n_words=1000, steps_run=i)
        us.append((time.perf_counter() - t) * 1e6)
    tel.finalize()
    shutil.rmtree(work / "step_boundary_cost", ignore_errors=True)
    return {"calls": calls, "median_us": statistics.median(us),
            "p99_us": percentile(us, 0.99)}


def telemetry_checks(torch, phase: str, tel_dir: Path, result, scraper, port: int,
                     n_steps: int, n_evals: int) -> dict:
    """``train:full``'s telemetry read after the run: fails unless
    ``metrics.jsonl`` holds one step row a step and one eval row an
    evaluation, the trace's step spans are exactly the ``FULL_TRACE_STEPS``
    window's, each eval row's ``hbm_peak_bytes`` is in (0, the run's
    ``max_memory_allocated``], ``mfu`` is in (0, 1), no anomaly fired, the
    endpoint answered all three scrapes, and the merged trace holds the
    trainer's step spans on its own track."""
    rows = [json.loads(line) for line in open(tel_dir / "metrics.jsonl", encoding="utf8")]
    steps = [r for r in rows if r["kind"] == "step"]
    evals = [r for r in rows if r["kind"] == "eval"]
    anomalies = [r for r in rows if r["kind"] == "anomaly"]
    trace = json.loads((tel_dir / "trace.json").read_text())["traceEvents"]
    spans = [e["args"]["step"] for e in trace if e.get("ph") == "X" and e["name"] == "step"]
    want_spans = list(range(FULL_TRACE_STEPS[0] + 1, FULL_TRACE_STEPS[1] + 1))
    peak = torch.cuda.max_memory_allocated()
    bad = []
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)):
        bad.append(f"step rows {[r['step'] for r in steps]}")
    if len(evals) != n_evals:
        bad.append(f"{len(evals)} eval rows, want {n_evals}")
    if spans != want_spans:
        bad.append(f"step spans {spans}, want {want_spans}")
    if not all(0 < (r["hbm_peak_bytes"] or 0) <= peak for r in evals):
        bad.append(f"hbm_peak_bytes {[r['hbm_peak_bytes'] for r in evals]} vs peak {peak}")
    if not all(isinstance(r["mfu"], float) and 0 < r["mfu"] < 1 for r in evals):
        bad.append(f"mfu {[r['mfu'] for r in evals]}")
    if anomalies:
        bad.append(f"anomalies on a healthy run: {anomalies}")
    if not all(scraper.got[k] for k in ("healthz", "metrics", "prometheus")) or \
            "# TYPE srt_training_steps_total counter" not in (scraper.prometheus or ""):
        bad.append(f"scrapes {scraper.got}")
    merged = scraper.merged or {"traceEvents": [], "otherData": {}}
    tracks = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
              if e["name"] == "process_name"}
    merged_steps = {e["pid"] for e in merged["traceEvents"] if e["name"] == "step"}
    if list(tracks.values()) != [f"trainer http://127.0.0.1:{port}"] or \
            merged_steps != set(tracks):
        bad.append(f"collect-trace: tracks {tracks}, step spans on {merged_steps}")
    if bad:
        fail(f"{phase}: telemetry: " + "; ".join(bad))
    return {
        "rows": {"step": len(steps), "eval": len(evals), "anomaly": 0},
        "trace_step_spans": [spans[0], spans[-1]], "trace_events": len(trace),
        "hbm_peak_bytes": [r["hbm_peak_bytes"] for r in evals], "max_memory_allocated": peak,
        "hbm_bytes_limit": evals[-1]["hbm_bytes_limit"],
        "live_buffers": [r["live_buffers"] for r in evals],
        "compile_count": [r["compile_count"] for r in evals],
        "mfu": [r["mfu"] for r in evals], "flops_per_step": evals[-1]["flops_per_step"],
        "step_seconds_p50": evals[-1]["step_seconds_p50"],
        "step_seconds_p95": evals[-1]["step_seconds_p95"],
        "scrapes": dict(scraper.got), "scraped_steps_max": scraper.max_steps_seen,
        "collect_trace_events": sum(1 for e in merged["traceEvents"] if e.get("ph") != "M"),
        "collect_trace_step_spans": sum(1 for e in merged["traceEvents"]
                                        if e["name"] == "step"),
    }


def telemetry_off_twin(torch, cfg, work: Path, nlp, result) -> dict:
    """``train:full``'s run again with telemetry off (no ``metrics_dir``, so
    no endpoint and no FLOP probe), its launches counted on their own: fails
    unless every parameter and every step's loss is bit-equal to the run with
    telemetry on. The two runs' CUDA-event medians are telemetry's cost a
    step end to end, in one process on one card."""
    from spacy_ray_tpu_torch.models.core import param_paths
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.training.loop import train

    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    nlp_off, off = train(cfg, work / "out_off", device="cuda", stdout_log=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    on, other = param_paths(nlp.model), param_paths(nlp_off.model)
    differ = sorted(k for k in on if k not in other or not torch.equal(on[k], other[k]))
    if differ or len(on) != len(other):
        fail(f"train:full: telemetry changed {len(differ)} of {len(on)} parameters on the "
             f"card (first {differ[:3]})")
    if off.step_losses != result.step_losses:
        fail("train:full: telemetry changed the step losses on the card")
    on_ms = statistics.median(a.elapsed_time(b) for a, b in result.step_events)
    off_ms = statistics.median(a.elapsed_time(b) for a, b in off.step_events)
    del nlp_off, other
    torch.cuda.empty_cache()
    return {"seconds": seconds, "params_bit_equal": True, "step_losses_equal": True,
            "step_ms_median_events": off_ms, "on_over_off_events_median": on_ms / off_ms,
            "step_ms_median_host": statistics.median(x * 1e3 for x in off.step_host_seconds),
            "launches": launches}


def phase_train_full(torch, udgen, full_shapes):
    """``train()`` on configs/trf.cfg as written (tagger, parser and NER over
    the full-width trunk) on the pseudo-UD corpus ``udgen`` (train, dev),
    launch counters zeroed just before and read just after, with telemetry on
    and its endpoint scraped (:func:`telemetry_checks`). Fails unless the
    leaves it trained are ``full_shapes``, those K5 was held at."""
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length
    from spacy_ray_tpu_torch.training.loop import train

    work = WORK / "train_full"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = trf_full_config()
    cfg["paths"] = {"train": str(udgen[0]), "dev": str(udgen[1])}
    cfg["training"]["max_steps"] = TRAIN_STEPS
    cfg["training"]["eval_frequency"] = TRAIN_EVAL
    cfg["training"]["trace_steps"] = FULL_TRACE_STEPS
    out, tel_dir, port = work / "out", work / "telemetry", free_base_port(1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with TelemetryScraper(port, collect_from=TRAIN_STEPS - 10) as scraper:
        nlp, result = train(cfg, out, device="cuda", stdout_log=False, metrics_dir=tel_dir,
                            metrics_port=port)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    telemetry = telemetry_checks(torch, "train:full", tel_dir, result, scraper, port,
                                 TRAIN_STEPS, TRAIN_STEPS // TRAIN_EVAL)
    probed_B, probed_T = result.step_shapes[TRAIN_EVAL - 1]
    n_tags = nlp.components["tagger"].model.dims["nO"]
    telemetry["flops_analytic_trunk_tagger"] = trf_step_flops(
        probed_B, probed_T, n_tags, int(cfg["training"]["accumulate_gradient"]))
    telemetry["flops_per_step_over_trunk_tagger"] = (
        telemetry["flops_per_step"] / telemetry["flops_analytic_trunk_tagger"])
    telemetry["probed_microbatch_B_T"] = [probed_B, probed_T]
    telemetry["step_boundary_host"] = step_boundary_host_us(work)
    telemetry_off = telemetry_off_twin(torch, cfg, work, nlp, result)

    need = ["hash_embed_gather_sum", "hash_embed_table_grad", "flash_attention_fwd",
            "flash_attention_bwd", "fused_update"]
    missing = [k for k in need if launches[k] == 0]
    if missing:
        fail(f"train:full: kernels never launched on the training path: {missing}")
    if len(result.step_head_losses) != TRAIN_STEPS:
        fail(f"train:full: {len(result.step_head_losses)} steps' losses, expected {TRAIN_STEPS}")
    head_losses = {}
    for head in ("tagger", "parser", "ner"):
        xs = [step[head] for step in result.step_head_losses]
        if not all(math.isfinite(x) for x in xs):
            fail(f"train:full: loss_{head} is not finite: {xs}")
        first, last = statistics.mean(xs[:5]), statistics.mean(xs[-5:])
        head_losses[head] = {"first5_mean": first, "last5_mean": last, "first": xs[0],
                             "last": xs[-1]}
        if not last <= 2 / 3 * first:
            fail(f"train:full: loss_{head} fell from {first} to only {last} (> 2/3)")
    event_ms = [a.elapsed_time(b) for a, b in result.step_events]
    trained_shapes = [tuple(p.shape) for p in nlp.model.parameters()]
    if trained_shapes != full_shapes:
        fail(f"train:full: trained {len(trained_shapes)} leaves, not the "
             f"{len(full_shapes)} leaves K5 was held at")

    # one microbatch of B 64, T 128 (the corpus's bucket): forward + backward
    # with every head and with the tagger alone (the parser's and the NER's
    # cost in the step), and the gradients of every leaf with the kernels
    # against the plain versions (dropout off)
    from spacy_ray_tpu_torch.registry import registry

    cfg_i = cfg.interpolate()
    corpus = registry.resolve(cfg_i["corpora"]["train"])
    batcher = registry.resolve(cfg_i["training"]["batcher"])
    batch = next(iter(batcher(corpus())))
    B_pad, T_pad = bucket_batch_size(len(batch)), bucket_length(max(len(eg) for eg in batch))
    c = nlp.collate(batch, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
    nlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}

    def fwd_bwd(targets):
        for p in params.values():
            p.grad = None
        nlp.loss(c["tokens"], targets, dropout=0.1, seed=1)[0].backward()

    split = {}
    for label, targets in (("all_heads", c["targets"]),
                           ("tagger_only", {"tagger": c["targets"]["tagger"]})):
        fwd_bwd(targets)
        dev_ms, host_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            fwd_bwd(targets)
            e1.record()
            host_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            dev_ms.append(e0.elapsed_time(e1))
        # kernel time alone (the events span host-paced gaps)
        ops = device_ops(torch, lambda: fwd_bwd(targets))
        split[label] = {"device_ms": statistics.median(dev_ms),
                        "host_ms": statistics.median(host_ms),
                        "kernel_ms": sum(v[1] for v in ops.values()),
                        "device_ops": sum(v[0] for v in ops.values())}
    # the FLOP probe the first evaluation ran, timed alone on the same microbatch
    from spacy_ray_tpu_torch.training.telemetry import program_flops

    torch.cuda.synchronize()
    t = time.perf_counter()
    telemetry["flops_probe_microbatch"] = program_flops(
        lambda: nlp.loss(c["tokens"], c["targets"], dropout=0.1, seed=1)[0], params)
    torch.cuda.synchronize()
    telemetry["flops_probe_s"] = time.perf_counter() - t
    telemetry["flops_probe_microbatch_B_T"] = [B_pad, T_pad]
    rel = grad_errs_vs_plain(torch, nlp, params, c)
    worst_leaf = max(rel, key=rel.get)
    if not rel[worst_leaf] <= TOL_GRAD:
        fail(f"train:full: gradient of {worst_leaf} kernels vs plain {rel[worst_leaf]} > {TOL_GRAD}")
    heads_worst = max((k for k in rel if k.startswith(("parser/", "ner/"))), key=rel.get)
    nlp.model.requires_grad_(False)
    oracle = dict(nlp.components["parser"].oracle_stats)
    n_leaves, n_params = len(params), sum(p.numel() for p in params.values())
    del nlp, params, c
    torch.cuda.empty_cache()

    keys = ("tag_acc", "dep_uas", "dep_las", "ents_f")
    res = {
        "phase": "train:full", "seconds": seconds, "steps": result.final_step,
        "leaves": n_leaves, "params": n_params,
        "group_shapes_B_T": sorted(set(result.step_shapes)), "head_losses": head_losses,
        "dev_scores": [(h["step"], {k: h["other_scores"].get(k) for k in keys})
                       for h in result.history],
        "dev_eval_words_per_s": [h["eval_wps"] for h in result.history],
        "step_ms_median_events": statistics.median(event_ms),
        "step_ms_median_host": statistics.median(x * 1e3 for x in result.step_host_seconds),
        "words_per_s": result.wps, "words": result.words_seen, "oracle": oracle,
        "peak_memory_gb": peak_gb, "launches": launches, "telemetry_off": telemetry_off,
        "telemetry": {**telemetry,
                      "step_seconds_p50_over_events_median":
                      telemetry["step_seconds_p50"] * 1e3 / statistics.median(event_ms)},
        "microbatch_B_T": [B_pad, T_pad], "fwd_bwd_split_ms": split,
        "heads_cost_ms_kernels": split["all_heads"]["kernel_ms"]
        - split["tagger_only"]["kernel_ms"],
        "heads_cost_device_ops": split["all_heads"]["device_ops"]
        - split["tagger_only"]["device_ops"],
        "heads_cost_ms_device": split["all_heads"]["device_ms"]
        - split["tagger_only"]["device_ms"],
        "heads_cost_ms_host": split["all_heads"]["host_ms"] - split["tagger_only"]["host_ms"],
        "grad_max_rel_err": rel[worst_leaf], "grad_worst_leaf": worst_leaf,
        "grad_heads_max_rel_err": rel[heads_worst], "grad_heads_worst_leaf": heads_worst,
        "grad_tol": TOL_GRAD,
    }
    emit(res)
    return res, out / "last-model"


def phase_slice_full(torch, model_dir: Path, dev_path: Path, auto: dict,
                     phase: str = "slice:full",
                     need=("hash_embed_gather_sum", "flash_attention_fwd"),
                     cpu_compare: bool = False, ents_floor: float = 0.95):
    """``model_dir`` (trained by ``train:full``, or by ``train:sm`` or
    ``train:md`` for ``phase`` slice:sm or slice:md) served over
    ``/v1/parse`` at ``--precision auto`` with slice:auto's traffic over
    pseudo-UD dev texts, every kernel of ``need`` launched, its p50 and p99
    set beside ``auto``'s (slice:auto's run, or slice:cnn's for the CNNs);
    the host ms of each rule component (no model: attribute ruler,
    lemmatizer, entity ruler) a dispatch and a request; with
    ``cpu_compare`` (an f32 model), the answers against the same model
    directory run on the CPU (>= 0.99, the entity sets' F >= ``ents_floor``);
    then, for one B 8, T 128 batch, the heads' decodes by graph replay
    (each on its trunk's output: the shared trunk's, or the NER's own trunk
    run eagerly), eager on the card, on the CPU and with every kernel swapped
    for its plain version, and their times."""
    import copy

    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.models.parser import (
        decode_biluo, decode_biluo_viterbi, decode_parser, ner_window_features,
    )
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.doc import Example
    from spacy_ray_tpu_torch.training.corpus import Corpus

    t0 = time.perf_counter()
    server = build_server([str(model_dir), "--port", "0", "--max-batch", "8",
                           "--max-doc-len", "128", "--precision", "auto"])
    engine = server.engine
    nlp = engine.nlp
    try:
        _, port = server.start()
        t_warm = time.perf_counter()
        engine.start()
        warmup_s = time.perf_counter() - t_warm
        graphs = nlp.decode_graphs
        if graphs is None or len(graphs) == 0:
            fail(f"{phase}: the warmup captured no decode graph")
        capture = {"graphs": len(graphs), "capture_s": graphs.capture_seconds,
                   "warmup_s": warmup_s, "buckets": len(engine.warmed)}
        setup_s = time.perf_counter() - t0

        texts = [" ".join(eg.reference.words) for eg in Corpus(dev_path)()
                 if len(eg.reference.words) <= 100][:24]
        latencies, answers = [], []
        lock = threading.Lock()

        def client(batch):
            for ts in batch:
                t = time.perf_counter()
                status, body = post(port, ts)
                with lock:
                    latencies.append(time.perf_counter() - t)
                    answers.append((status, ts, body))

        sequential = [[t] for t in texts[:4]]
        concurrent = [[[texts[4 + 5 * c + i]] if i % 2 else texts[4 + 5 * c + i: 6 + 5 * c + i]
                       for i in range(3)] for c in range(4)]
        replays0 = graphs.replays
        rules = [n for n in nlp.pipe_names if nlp.components[n].model is None]
        # the host's decodes timed alike: the rule components' and an entity linker's
        linkers = [n for n in nlp.pipe_names if hasattr(nlp.components[n], "kb")]
        rule_s = {n: [] for n in rules + linkers}

        def timed(name, fn):
            def wrapped(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    rule_s[name].append(time.perf_counter() - t)
            return wrapped

        patches = [mock.patch.object(nlp.components[n], "set_annotations",
                                     timed(n, nlp.components[n].set_annotations))
                   for n in rule_s]
        for patch in patches:
            patch.start()
        _cuda.reset_launch_counts()
        try:
            client(sequential)
            threads = [threading.Thread(target=client, args=(c,)) for c in concurrent]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        finally:
            for patch in patches:
                patch.stop()
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
        replays = graphs.replays - replays0
        rule_host_ms = {n: {"per_dispatch": 1e3 * statistics.mean(ts),
                            "per_request": 1e3 * sum(ts) / len(answers), "dispatches": len(ts)}
                        for n, ts in rule_s.items()}
        linker_host_ms = {n: rule_host_ms.pop(n) for n in linkers}
        missing = [k for k in need if launches[k] == 0]
        if missing:
            fail(f"{phase}: kernels never launched on the main path: {missing}")
        if replays == 0:
            fail(f"{phase}: no decode graph was replayed on the main path")
        n_docs = n_with_ents = n_ents = n_linked = 0
        labels_dep = set(nlp.components["parser"].labels) | {"ROOT"}
        for status, ts, body in answers:
            if status != 200 or len(body["docs"]) != len(ts):
                fail(f"{phase}: /v1/parse answered {status}: {body}")
            for d in body["docs"]:
                n = len(d["tokens"])
                if not (len(d.get("tags", [])) == len(d.get("heads", [])) == len(d.get("deps", []))
                        == n) or not all(0 <= h < n for h in d["heads"]):
                    fail(f"{phase}: doc without tags, heads or deps: {d}")
                check_served_doc(nlp, d, phase)  # the rule components' pos and lemmas
                if not set(d["deps"]) <= {l.split("||")[0] for l in labels_dep}:
                    fail(f"{phase}: unknown dep labels in {d['deps']}")
                n_docs += 1
                n_with_ents += bool(d.get("ents"))
                n_ents += len(d.get("ents", []))
                n_linked += sum(len(e) > 3 for e in d.get("ents", []))
        if n_ents == 0:
            fail(f"{phase}: no response carried an entity")
        if linkers and n_linked == 0:
            fail(f"{phase}: no served entity carried a kb_id")
        pipeline_vs_cpu = None
        if cpu_compare:
            pipeline_vs_cpu = card_vs_cpu(model_dir, answers)
            low = {k: v for k, v in pipeline_vs_cpu.items()
                   if v < (ents_floor if k == "ents_f" else 0.99)}
            if low:
                fail(f"{phase}: served answers and the CPU's agree only {pipeline_vs_cpu}")

        # one batch at the top bucket (B 8, T 128)
        docs = [nlp.tokenizer(t) for t in texts[:8]]
        tokens = nlp.collate([Example.from_gold(d) for d in docs], pad_batch_to=8,
                             pad_len_to=128)["tokens"]
        overlay = engine.overlay.overlay
        parser, ner = nlp.components["parser"], nlp.components["ner"]
        with torch.inference_mode():
            out_k = nlp.forward(tokens, overlay)
            with plain_kernels():
                out_p = nlp.forward(tokens, overlay)
            mask = out_k[nlp.tok2vec_name].mask
            lengths = mask.sum(1)
            # each head's trunk output: the shared trunk's through a
            # listener, or its own trunk's (md's NER), run eagerly
            Xs = {n: nlp.components[n].trunk_output(
                      out_k[nlp.tok2vec_name] if nlp.components[n].listens else tokens).X
                  for n in ("parser", "ner")}
            eager = {n: nlp.components[n].device_decode(Xs[n], lengths)
                     for n in ("parser", "ner")}
            replay = {n: {k: v.clone() for k, v in
                          graphs.run(n, nlp.components[n], Xs[n], lengths).items()}
                      for n in ("parser", "ner")}
            for n in eager:
                for k in eager[n]:
                    if not torch.equal(eager[n][k], replay[n][k]):
                        fail(f"{phase}: {n} {k}: graph replay differs from the eager decode")
            # the same trunk outputs and head weights decoded on the CPU
            lc = lengths.cpu()
            up_p = copy.deepcopy(parser.model.upper).cpu()
            up_n = copy.deepcopy(ner.model.upper).cpu()
            heads_c, labels_c = decode_parser(up_p, Xs["parser"].float().cpu(), lc,
                                              len(parser.labels))
            ner_fn = decode_biluo_viterbi if ner.decode == "viterbi" else decode_biluo
            acts_c = ner_fn(up_n.step_logits(Xs["ner"].float().cpu(),
                                             ner_window_features(128, lc)), lc, len(ner.labels))
        real = mask.cpu()

        def agree(a, b):
            return (a.cpu()[real] == b.cpu()[real]).float().mean().item()

        cpu_agree = {"heads": agree(eager["parser"]["heads"], heads_c),
                     "labels": agree(eager["parser"]["labels"], labels_c),
                     "biluo_actions": agree(eager["ner"]["actions"], acts_c)}
        if min(cpu_agree.values()) < 0.99:
            fail(f"{phase}: card and CPU decodes agree only {cpu_agree} (< 0.99)")
        lens = lengths.tolist()
        plain_agree = {
            "heads": agree(out_k["parser"]["heads"], out_p["parser"]["heads"]),
            "ents_f": set_f(entity_set(out_k["ner"]["actions"], lens, ner.labels),
                            entity_set(out_p["ner"]["actions"], lens, ner.labels)),
        }
        if plain_agree["heads"] < 0.95 or plain_agree["ents_f"] < 0.95:
            fail(f"{phase}: kernels vs plain versions agree only {plain_agree} (< 0.95)")

        # the decodes' device and host-enqueue times at B 8, T 128, as a graph
        # replay and eagerly, and the device operations of each
        decode_times = {}
        with torch.inference_mode():
            for n in ("parser", "ner"):
                comp, X = nlp.components[n], Xs[n]

                def run_graph():
                    graphs.run(n, comp, X, lengths)

                def run_eager():
                    comp.device_decode(X, lengths)

                ops_g, ops_e = device_ops(torch, run_graph), device_ops(torch, run_eager)
                # spin_cap_s 1.0: the eager decode takes ~105 ms to enqueue, past the
                # default 50 ms cap, and its device time must not count host pacing
                decode_times[n] = {
                    "graph_ms": time_ms(torch, run_graph, reps=10, spin_cap_s=1.0),
                    "graph_enqueue_ms": enqueue_ms(torch, run_graph),
                    "eager_ms": time_ms(torch, run_eager, reps=5, spin_cap_s=1.0),
                    "eager_enqueue_ms": enqueue_ms(torch, run_eager, reps=5),
                    "device_ops_graph": sum(v[0] for v in ops_g.values()),
                    "device_ops_eager": sum(v[0] for v in ops_e.values()),
                    "device_ops_eager_ms": sum(v[1] for v in ops_e.values()),
                    "top_ops_eager": sorted(ops_e.items(), key=lambda kv: -kv[1][0])[:8],
                }

            def forward_graphs():
                nlp.forward(tokens, overlay, graphs)

            # spin_cap_s 1.0: the trunk's enqueue outlasts the default cap, as above
            forward = {"ms": time_ms(torch, forward_graphs, reps=10, spin_cap_s=1.0),
                       "enqueue_ms": enqueue_ms(torch, forward_graphs)}

        server.request_shutdown()
        rc = server.wait()
        if rc != 0:
            fail(f"{phase}: serve drain returned {rc}")
        result = {
            "phase": phase, "precision_label": engine.overlay.label,
            "requests": len(answers), "docs": n_docs, "docs_with_ents": n_with_ents,
            "ents": n_ents, "batches_seen": sorted({(b["batch"]["B"], b["batch"]["T"],
                                                     b["batch"]["occupancy"])
                                                    for _, _, b in answers}),
            "launches": launches, "graph_replays": replays,
            "latency_p50_ms": percentile(latencies, 0.50) * 1e3,
            "latency_p99_ms": percentile(latencies, 0.99) * 1e3,
            "auto_latency_p50_ms": auto["latency_p50_ms"],
            "auto_latency_p99_ms": auto["latency_p99_ms"],
            "setup_s": setup_s, "capture": capture, "rule_host_ms": rule_host_ms,
            "linker_host_ms": linker_host_ms, "ents_linked": n_linked,
            "graph_equals_eager": True, "card_vs_cpu_agreement": cpu_agree,
            "served_vs_cpu_pipeline": pipeline_vs_cpu,
            "kernels_vs_plain": plain_agree, "decode_B8_T128": decode_times,
            "forward_B8_T128_with_graphs": forward,
        }
        emit(result)
        return result
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine, nlp
        torch.cuda.empty_cache()

# ------------------------------------------------------------- CNN paths


def cnn_config(name: str, paths):
    """configs/<name>.cfg as written (cnn.cfg: tok2vec + tagger; sm.cfg: the
    same with parser and NER), its corpora pointed at ``paths`` (train, dev)."""
    from spacy_ray_tpu_torch import Config

    cfg = Config.from_disk(ROOT / "configs" / f"{name}.cfg")
    want = {"cnn": ["tok2vec", "tagger"], "sm": ["tok2vec", "tagger", "parser", "ner"]}[name]
    if cfg["nlp"]["pipeline"] != want:
        fail(f"configs/{name}.cfg pipeline = {cfg['nlp']['pipeline']}")
    model = cfg["components"]["tok2vec"]["model"]
    for key, value in (("@architectures", "spacy.HashEmbedCNN.v2"), ("width", CNN_WIDTH),
                       ("depth", 4), ("embed_size", 2000)):
        if model[key] != value:
            fail(f"configs/{name}.cfg tok2vec {key} = {model[key]}, expected {value}")
    cfg["paths"] = {"train": str(paths[0]), "dev": str(paths[1])}
    return cfg


def spancat_config(paths):
    """configs/spancat.cfg as written (tok2vec + spancat + textcat_multilabel),
    its corpora pointed at ``paths``."""
    from spacy_ray_tpu_torch import Config

    cfg = Config.from_disk(ROOT / "configs" / "spancat.cfg")
    if cfg["nlp"]["pipeline"] != ["tok2vec", "spancat", "textcat_multilabel"]:
        fail(f"configs/spancat.cfg pipeline = {cfg['nlp']['pipeline']}")
    model = cfg["components"]["tok2vec"]["model"]
    for key, value in (("@architectures", "spacy.HashEmbedCNN.v2"), ("width", CNN_WIDTH),
                       ("depth", 4), ("embed_size", 2000)):
        if model[key] != value:
            fail(f"configs/spancat.cfg tok2vec {key} = {model[key]}, expected {value}")
    cfg["paths"] = {"train": str(paths[0]), "dev": str(paths[1])}
    return cfg


def textcat_config(paths):
    """spaCy's default ``textcat`` over cnn.cfg's trunk: a TextCatEnsemble.v2
    whose neural half runs cnn.cfg's tok2vec block inline and whose linear
    half is a TextCatBOW.v3 (unigrams, 262144 rows, no nO); cnn.cfg's
    [training] block, scored by ``cats_score``."""
    cfg = cnn_config("cnn", paths)
    trunk = cfg["components"].pop("tok2vec")["model"]
    cfg["components"].pop("tagger")
    cfg["nlp"]["pipeline"] = ["textcat"]
    cfg["components"]["textcat"] = {"factory": "textcat", "model": {
        "@architectures": "spacy.TextCatEnsemble.v2", "tok2vec": trunk,
        "linear_model": {"@architectures": "spacy.TextCatBOW.v3", "exclusive_classes": True,
                         "ngram_size": 1, "no_output_layer": False, "length": 262144}}}
    cfg["training"]["score_weights"] = {"cats_score": 1.0}
    return cfg


def tokcls_config(paths):
    """cnn.cfg as written with the morphologizer, senter and trainable
    lemmatizer (``min_tree_freq`` 3, ``top_k`` 3) beside its tagger, each a
    ``spacy.Tagger.v2`` head over a listener; the five scores weighted alike."""
    cfg = cnn_config("cnn", paths)
    listener = cfg["components"]["tagger"]["model"]["tok2vec"]
    for name in ("morphologizer", "senter", "trainable_lemmatizer"):
        block = {"factory": name, "model": {"@architectures": "spacy.Tagger.v2",
                                            "tok2vec": dict(listener)}}
        if name == "trainable_lemmatizer":
            block.update(min_tree_freq=3, top_k=3)
        cfg["components"][name] = block
    cfg["nlp"]["pipeline"] = ["tok2vec", "tagger", "morphologizer", "senter",
                              "trainable_lemmatizer"]
    cfg["training"]["score_weights"] = {k: 0.2 for k in ("tag_acc", "pos_acc", "morph_acc",
                                                         "lemma_acc", "sents_f")}
    return cfg


def md_trunk(width: int = CNN_WIDTH, depth: int = 4, rows=MD_ROWS):
    """spaCy md's trunk: Tok2Vec.v2 of MultiHashEmbed.v2 (NORM, PREFIX,
    SUFFIX, SHAPE at ``rows``, with the static vectors) and a maxout window
    encoder (window 1, 3 pieces)."""
    return {"@architectures": "spacy.Tok2Vec.v2",
            "embed": {"@architectures": "spacy.MultiHashEmbed.v2", "width": width,
                      "attrs": ["NORM", "PREFIX", "SUFFIX", "SHAPE"], "rows": list(rows),
                      "include_static_vectors": True},
            "encode": {"@architectures": "spacy.MaxoutWindowEncoder.v2", "width": width,
                       "depth": depth, "window_size": 1, "maxout_pieces": 3}}


def md_config(paths, vectors, attr_patterns, ent_patterns, *, width: int = CNN_WIDTH,
              depth: int = 4, rows=MD_ROWS, hidden: int = 64):
    """spaCy's md pipeline layout from configs/sm.cfg: ``tok2vec`` (md's
    trunk), ``tagger`` and ``parser`` (hidden 64, 2 pieces) over listeners,
    ``attribute_ruler`` (``attr_patterns``), ``lemmatizer`` (rule mode),
    ``ner`` (hidden 64) over a trunk of its own alike, ``entity_ruler``
    (``ent_patterns``, ``overwrite_ents`` false); ``[initialize] vectors``
    is ``vectors``; sm.cfg's [training] and score weights. The keyword
    arguments shrink it for the CPU tests."""
    cfg = cnn_config("sm", paths)
    comps = cfg["components"]
    comps["tok2vec"]["model"] = md_trunk(width, depth, rows)
    for name in ("tagger", "parser"):
        comps[name]["model"]["tok2vec"]["width"] = width
    comps["parser"]["model"]["hidden_width"] = hidden
    comps["ner"]["model"].update(hidden_width=hidden, tok2vec=md_trunk(width, depth, rows))
    comps["attribute_ruler"] = {"factory": "attribute_ruler", "patterns": attr_patterns}
    comps["lemmatizer"] = {"factory": "lemmatizer", "mode": "rule"}
    comps["entity_ruler"] = {"factory": "entity_ruler", "patterns": ent_patterns,
                             "overwrite_ents": False}
    cfg["nlp"]["pipeline"] = ["tok2vec", "tagger", "parser", "attribute_ruler", "lemmatizer",
                              "ner", "entity_ruler"]
    cfg["initialize"] = {"vectors": str(vectors)}
    return cfg


def md_assets(train_path, work: Path, *, seed: int = 0, rows: int = MD_VECTORS[0],
              dim: int = MD_VECTORS[1]):
    """What ``md_config`` needs from the train corpus, made from ``seed``:

    * the vectors: a word2vec text file of ``rows`` x ``dim`` seeded normal
      values, converted by the port's ``init-vectors`` into
      ``work/vectors.npz``. Its first rows are the corpus's word types by
      frequency, with every 8th type left out (no vector: row -1) and each
      capitalised type only in lower case (found through the lower-case
      fallback); filler words take the rest;
    * the attribute ruler's patterns: each TAG of the corpus mapped to its
      most frequent POS;
    * the entity ruler's patterns: the corpus's four most frequent entity
      mentions with their gold labels, two as phrase patterns and two as
      token patterns on LOWER.

    Returns (vectors path, attribute patterns, entity patterns, counts)."""
    import collections

    import numpy as np

    from spacy_ray_tpu_torch.__main__ import main as cli
    from spacy_ray_tpu_torch.pipeline.vectors import Vectors
    from spacy_ray_tpu_torch.training.corpus import Corpus

    docs = [eg.reference for eg in Corpus(train_path)()]
    words = collections.Counter(w for d in docs for w in d.words)
    tag_pos = collections.defaultdict(collections.Counter)
    mentions = collections.Counter()
    for d in docs:
        for t, p in zip(d.tags, d.pos):
            tag_pos[t][p] += 1
        mentions.update((tuple(d.words[e.start:e.end]), e.label) for e in d.ents)
    types = sorted(words, key=lambda w: (-words[w], w))
    kept = list(dict.fromkeys(w.lower() for i, w in enumerate(types) if i % 8 != 7))
    if len(kept) > rows:
        fail(f"md vectors: {len(kept)} corpus words do not fit {rows} rows")
    vocab = kept + [f"filler{i:05d}" for i in range(rows - len(kept))]
    table = np.random.default_rng(seed).standard_normal((rows, dim), dtype=np.float32)
    work.mkdir(parents=True, exist_ok=True)
    text = work / "vectors.txt"
    with open(text, "w", encoding="utf8") as f:
        f.write(f"{rows} {dim}\n")
        for w, row in zip(vocab, table):
            f.write(w + " " + " ".join(f"{x:.4f}" for x in row) + "\n")
    out = work / "vectors.npz"
    if cli(["init-vectors", str(text), str(out)]) != 0:
        fail("md: init-vectors failed")
    text.unlink()
    attr = [{"patterns": [[{"TAG": t}]], "attrs": {"POS": c.most_common(1)[0][0]}}
            for t, c in sorted(tag_pos.items())]
    top = [m for m, _ in sorted(mentions.items(), key=lambda kv: (-kv[1], kv[0]))[:4]]
    ents = ([{"label": lab, "pattern": " ".join(ws)} for ws, lab in top[:2]]
            + [{"label": lab, "pattern": [{"LOWER": w.lower()} for w in ws]}
               for ws, lab in top[2:]])
    vec = Vectors.from_disk(out)
    found = {w: vec.row_of(w) >= 0 for w in types}
    exact = sum(w in vec.key_to_row for w in types)
    counts = {"rows": len(vec), "width": vec.width, "corpus_tokens": sum(words.values()),
              "corpus_types": len(types), "types_exact": exact,
              "types_lower_case_fallback": sum(found.values()) - exact,
              "types_without_a_vector": len(types) - sum(found.values()),
              "tokens_without_a_vector": sum(n for w, n in words.items() if not found[w])}
    return out, attr, ents, counts


#: the md pipeline's components, sourced by ``nel_config`` and frozen there
MD_PIPELINE = ["tok2vec", "tagger", "parser", "attribute_ruler", "lemmatizer", "ner",
               "entity_ruler"]
NEL_VECTOR_WIDTH = 64       # spaCy's nel_emerson tutorial's entity_vector_length
NEL_CANDIDATES = (4, 8)     # entities an alias has, drawn from the seed (both ends included)
#: (step, epoch) of every ``[training.before_update]`` call of ``nel_config``
STEP_CALLS = []
STEP_RECORDER = "chip_smoke.step_recorder.v1"


def register_step_recorder(registry) -> None:
    """Register, in ``registry`` (either package's), the callback
    ``nel_config`` names: it appends each call's (step, epoch) to
    ``STEP_CALLS``."""
    def make():
        def before_update(nlp, info):
            STEP_CALLS.append((info["step"], info["epoch"]))
        return before_update

    registry.callbacks(STEP_RECORDER)(make)


def nel_context_class(doc, start: int) -> int:
    """The gold entity's candidate number for a mention starting at
    ``start``: 0 when it starts its sentence, 1 after a verb, 2 after an
    adposition, 3 after anything else."""
    starts = doc.sent_starts
    if start == 0 or (starts is not None and starts[start] == 1):
        return 0
    return {"VERB": 1, "ADP": 2}.get(doc.pos[start - 1], 3)


def nel_assets(paths, work: Path, *, seed: int = 0, dim: int = NEL_VECTOR_WIDTH,
               shared: bool = False):
    """A knowledge base and entity-linking corpora made from ``seed`` over
    the udgen ``.spacy`` corpora ``paths`` (train, dev):

    * each of udgen's 120 two-word mention types is an alias (its words,
      space-joined) with 4-8 candidate entities ``Q<alias>_<k>`` (the count
      drawn from the seed), each with its own ``dim``-wide standard normal
      vector and a prior drawn from a Dirichlet(2) over the alias's
      candidates; with ``shared``, each vector is instead the sum of
      candidate ``k``'s direction, shared by every alias, and its own
      (halves N(0, 1/2): still standard normal), so what is learnt of one
      alias's candidate ``k`` carries to the others;
    * the gold entity of a mention is its alias's candidate ``k =
      nel_context_class``: context decides the link, priors do not.

    Both variants draw the same counts, priors and gold entities.

    Writes ``work/kb.npz`` (the port's ``KnowledgeBase.to_disk``) and
    ``work/{train,dev}.spacy`` with the gold kb_id on every entity. Returns
    (kb path, (train, dev), counts with the dev ``nel_micro_f`` of the
    prior-only decode: the top-prior candidate of each gold mention)."""
    import numpy as np

    from spacy_ray_tpu_torch.pipeline.kb import KnowledgeBase
    from spacy_ray_tpu_torch.training.corpus import Corpus
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin
    from spacy_ray_tpu_torch.udgen import _Lexicon

    rng = np.random.default_rng(seed)
    aliases = [" ".join(words) for words, _ in _Lexicon(random.Random(1234)).propn]
    kb = KnowledgeBase(dim)
    per_alias = []
    senses = rng.standard_normal((NEL_CANDIDATES[1], dim))
    for a, alias in enumerate(aliases):
        n = int(rng.integers(NEL_CANDIDATES[0], NEL_CANDIDATES[1] + 1))
        ents = [f"Q{a}_{k}" for k in range(n)]
        own = rng.standard_normal((n, dim))
        vecs = (senses[:n] + own) / math.sqrt(2) if shared else own
        for ent, vec in zip(ents, vecs.astype(np.float32)):
            kb.add_entity(ent, 1.0, vec)
        kb.add_alias(alias, ents, rng.dirichlet([2.0] * n).tolist())
        per_alias.append(n)
    work.mkdir(parents=True, exist_ok=True)
    kb_path = work / "kb.npz"
    kb.to_disk(kb_path)
    out, mentions, hits = [], {}, 0
    alias_index = {alias: a for a, alias in enumerate(aliases)}
    for split, src in zip(("train", "dev"), paths):
        docs = [eg.reference for eg in Corpus(src)()]
        n = 0
        for doc in docs:
            for e in doc.ents:
                alias = " ".join(doc.words[e.start:e.end])
                e.kb_id = f"Q{alias_index[alias]}_{nel_context_class(doc, e.start)}"
                n += 1
                if split == "dev":
                    hits += kb.candidates(alias)[0].entity == e.kb_id
        path = work / f"{split}.spacy"
        write_docbin(path, docs)
        out.append(path)
        mentions[split] = n
    counts = {"entities": len(kb), "aliases": len(aliases),
              "candidates_per_alias": {"min": min(per_alias), "max": max(per_alias),
                                       "mean": sum(per_alias) / len(per_alias)},
              "mentions": mentions, "kb_file_bytes": kb_path.stat().st_size,
              # every gold mention gets one link: precision = recall = F
              "prior_only_dev_nel_micro_f": hits / max(mentions["dev"], 1)}
    (work / "counts.json").write_text(json.dumps(counts), encoding="utf8")
    return kb_path, tuple(out), counts


def nel_config(paths, source: Path, kb_path: Path, *, width: int = CNN_WIDTH,
               depth: int = 2, embed_size: int = 2000, sourced=MD_PIPELINE):
    """An entity linker added to a trained md pipeline, as spaCy's
    ``nel_emerson`` tutorial adds one to a shipped pipeline: every component
    of ``md_config`` sourced from ``source`` (its vectors adopted) and
    frozen, the NER annotating, and ``entity_linker`` (8 candidates, priors
    on, trained on the NER's predicted mentions) over
    ``spacy.EntityLinker.v2`` with a ``HashEmbedCNN.v2`` trunk of its own
    (the tutorial's: width 96, depth 2, embed_size 2000, window 1, 3
    pieces, subword features); ``[training.before_update]`` is the step
    recorder; sm.cfg's [training] otherwise, scored by ``nel_micro_f``.
    The keyword arguments shrink the linker's trunk, and ``sourced`` the
    components taken from ``source``, for the CPU tests and fixtures."""
    from spacy_ray_tpu_torch.registry import registry

    register_step_recorder(registry)
    cfg = cnn_config("sm", paths)
    comps = {name: {"source": str(source)} for name in sourced}
    comps["entity_linker"] = {
        "factory": "entity_linker", "n_candidates": 8, "use_gold_ents": False,
        "use_prior": True, "kb_path": str(kb_path),
        "model": {"@architectures": "spacy.EntityLinker.v2",
                  "tok2vec": {"@architectures": "spacy.HashEmbedCNN.v2", "width": width,
                              "depth": depth, "embed_size": embed_size, "window_size": 1,
                              "maxout_pieces": 3, "subword_features": True,
                              "pretrained_vectors": None}}}
    cfg["components"] = comps
    cfg["nlp"]["pipeline"] = list(sourced) + ["entity_linker"]
    cfg["training"].update(frozen_components=list(sourced),
                           annotating_components=["ner"],
                           before_update={"@callbacks": STEP_RECORDER},
                           score_weights={"nel_micro_f": 1.0})
    return cfg


def pipeline_config(name: str, paths):
    if name in ("cnn", "sm"):
        return cnn_config(name, paths)
    return {"spancat": spancat_config, "textcat": textcat_config,
            "tokcls": tokcls_config}[name](paths)


def write_head_corpora():
    """The classifiers' corpora, written as .spacy by the port's writer from
    the port's generators: spancat's 1000 span docs and 1000 cat docs in
    turn (100 + 100 dev), textcat's 2000 cat docs (200 dev). Returns
    {name: (train, dev)}."""
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin
    from spacy_ray_tpu_torch.util import synth_corpus

    def docs(kind, n, seed):
        return [eg.reference for eg in synth_corpus(n, kind, seed)]

    work = WORK / "head_corpora"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    for name, splits in (
            ("spancat", {"train": (("spancat", 1000, 0), ("textcat", 1000, 1)),
                         "dev": (("spancat", 100, 2), ("textcat", 100, 3))}),
            ("textcat", {"train": (("textcat", 2000, 4),), "dev": (("textcat", 200, 5),)})):
        paths = []
        for split, parts in splits.items():
            path = work / f"{name}_{split}.spacy"
            columns = [docs(*part) for part in parts]
            write_docbin(path, [d for row in zip(*columns) for d in row])
            paths.append(path)
        out[name] = tuple(paths)
    return out


def write_spacy_corpus(udgen):
    """The udgen corpus (train, dev .jsonl) written as spaCy DocBins by the
    port's writer: the CNN phases read .spacy files. Returns (train, dev)."""
    from spacy_ray_tpu_torch.training.corpus import read_jsonl_docs
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin

    work = WORK / "spacy_corpus"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = (work / "train.spacy", work / "dev.spacy")
    for src, dst in zip(udgen, out):
        write_docbin(dst, read_jsonl_docs(src))
    return out


def cnn_setup(torch, configs, trunk="tok2vec"):
    """Built on the CPU from ``configs`` ({name: config}), labels collected
    from each one's corpus as ``train()`` collects them: the leaf shapes of
    cnn.cfg, sm.cfg, spancat.cfg, the textcat ensemble, the token
    classifiers, the md layout and ``nel_config`` (those their ``train:*``
    phases update: md's frozen tables are no leaves; a frozen component's
    leaves are, with zero gradients, listed under ``"zero_grad_leaves"``),
    and the hash keys of ``train:cnn``'s, ``train:spancat``'s,
    ``train:md``'s and ``train:nel``'s first microbatches with the (rows,
    seed, attribute) of each table of the component ``trunk``."""
    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.models.layers import HashEmbed
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length

    info = {"microbatches": {}, "zero_grad_leaves": {}}
    for name, cfg in configs.items():
        cfg = cfg.interpolate()
        nlp = Pipeline.from_config(cfg, device="cpu")
        nlp.initialize(registry.resolve(cfg["corpora"]["train"]), seed=0)
        info[name] = [tuple(p.shape) for p in nlp.model.parameters()]
        if name == "cnn":  # by path, for the fleet's owner slices
            info["cnn_paths"] = {k.replace(".", "/"): tuple(p.shape)
                                 for k, p in nlp.model.named_parameters()}
        nlp.requires_grad_(True)
        info["zero_grad_leaves"][name] = [
            i for i, p in enumerate(nlp.model.parameters()) if not p.requires_grad]
        if name in ("cnn", "spancat", "md", "nel"):
            batcher = registry.resolve(cfg["training"]["batcher"])
            batch = next(iter(batcher(registry.resolve(cfg["corpora"]["train"])())))
            B, T = bucket_batch_size(len(batch)), bucket_length(max(len(eg) for eg in batch))
            tokens = nlp.collate(batch, pad_batch_to=B, pad_len_to=T)["tokens"]
            info["microbatches"][name] = {
                "B": B, "T": T, "docs": len(batch), "words": int(tokens.mask.sum()),
                "keys": tokens.attr_keys.reshape(B * T, -1, 2),
                "tables": [(m.dims["rows"], m.seed, m.attr_index)
                           for m in nlp.model[trunk].modules() if isinstance(m, HashEmbed)]}
    return info


CNN_LEAF_SETS = (("cnn", "cnn.cfg"), ("sm", "sm.cfg"), ("spancat", "spancat.cfg"),
                 ("textcat", "textcat ensemble"), ("tokcls", "token classifiers"),
                 ("md", "md layout (its two frozen tables left out)"))


def phase_cnn_kernels(torch, info, leaf_sets=CNN_LEAF_SETS):
    """K1 fwd, K1 bwd and K5 at the CNN's shapes, each against its plain
    version and timed: K1 at D 96 over the 2000- and 1000-row tables and
    md's 5000-, 1000- and 2500-row tables, at ``train:cnn``'s,
    ``train:spancat``'s and ``train:md``'s first microbatches (the corpora's
    ids; md's two trunks hash alike, two calls a table) and at one request
    (N 128, uniform keys); K5 over the leaves of cnn.cfg, sm.cfg,
    spancat.cfg, the textcat ensemble (its 262144 x 3 BOW table's gradient
    zero but on the rows a microbatch touches), the token classifiers and
    the md layout (labels from the corpora) under three hyper sets, at 0
    ulp; or the ``leaf_sets`` given, a frozen component's leaves with zero
    gradients (``train:nel``'s)."""
    import torch.nn.functional as F

    from spacy_ray_tpu_torch.ops.fused_update import (
        FusedHyper, FusedUpdate, global_norm, leaf_math_plain, step_scalars,
    )
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids
    from spacy_ray_tpu_torch.ops.pallas_kernels import (
        hash_embed_gather_sum, hash_embed_gather_sum_plain, hash_embed_table_grad,
        hash_embed_table_grad_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def flush():
        scratch.zero_()

    D = CNN_WIDTH
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(1), flush=flush)
    keys_one = torch.randint(0, 2 ** 32, (128, 2), device=dev, generator=g)
    # one request (N 128): cnn.cfg's NORM table and a 1000-row table; md's
    # 5000-, 1000- and 2500-row tables
    one_request = {"cnn": (0, 1), "md": (0, 1, 2)}
    cases = []
    for phase, mb in info["microbatches"].items():
        keys_mb = mb["keys"].to(dev)
        calls = 2 if phase == "md" else 1  # md: the shared trunk's and the NER's
        for ti, (rows, seed, attr) in enumerate(mb["tables"]):
            cases.append((rows, seed, keys_mb[:, attr], "corpus", f"train:{phase} microbatch",
                          calls))
            if ti in one_request.get(phase, ()):
                cases.append((rows, seed, keys_one, "uniform", "one request (N 128)", calls))
    fwd, bwd = [], []
    for rows, seed, keys, ids_kind, dispatch, calls in cases:
        ids = hash_embed_ids(keys, seed, rows)
        n = ids.shape[0]
        table = torch.randn(rows, D, device=dev, generator=g)
        got = hash_embed_gather_sum(table, ids)
        err = (got - hash_embed_gather_sum_plain(table, ids)).abs().max().item()
        if not err <= TOL_K1:
            fail(f"K1 D={D} rows={rows} N={n}: max_abs_err {err} > {TOL_K1}")
        ids_l = ids.long()
        distinct = int(torch.unique(ids).numel())
        bnd, by = bound_ms(distinct * D * 4 + n * D * 4 + n * 16, 3 * n * D, PEAK_F32_FLOPS)
        row = {
            "rows": rows, "D": D, "N": n, "ids": ids_kind, "distinct_rows": distinct,
            "max_abs_err": err, "dispatch": dispatch, "calls_per_dispatch": calls,
            "ms": time_ms(torch, lambda: hash_embed_gather_sum(table, ids), flush=flush),
            "host_us": host_us(torch, lambda: hash_embed_gather_sum(table, ids)),
            "plain_ms": time_ms(torch, lambda: hash_embed_gather_sum_plain(table, ids),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(ids_l, table, mode="sum"),
                                  flush=flush),
            "bound_ms": bnd, "bound_by": by, "timer_floor_ms": floor_ms,
        }
        emit({"phase": "kernel:hash_embed_gather_sum", **row})
        fwd.append(row)

        ct = torch.randn(n, D, device=dev, generator=g)
        got = hash_embed_table_grad(ct, ids, rows)
        again = hash_embed_table_grad(ct, ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K1 bwd D={D} rows={rows}: two runs on the same inputs differ")
        want_cpu = hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows)
        err = (got.cpu() - want_cpu).abs().max().item()
        err_card = (got - hash_embed_table_grad_plain(ct, ids, rows)).abs().max().item()
        # the card's plain version sums with atomics, in no fixed order:
        # the kernel is held bit-equal to the CPU's, which walks its index
        # in order, and its distance from the card's is reported
        if not err <= TOL_K1_BWD:
            fail(f"K1 bwd D={D} rows={rows} N={n}: max_abs_err {err} vs the CPU plain "
                 f"version > {TOL_K1_BWD}")
        flat = ids.reshape(-1).long()
        ct4 = ct.repeat_interleave(4, 0)
        bnd, by = bound_ms(rows * D * 4 + n * D * 4 + n * 16, 4 * n * D, PEAK_F32_FLOPS)
        row = {
            "rows": rows, "D": D, "N": n, "ids": ids_kind, "dispatch": dispatch,
            "calls_per_dispatch": calls,
            "longest_segment": int(torch.bincount(flat).max()),
            "max_abs_err": err, "max_abs_err_vs_card_plain": err_card,
            "bit_identical_rerun": True,
            "ms": time_ms(torch, lambda: hash_embed_table_grad(ct, ids, rows), flush=flush),
            "host_us": host_us(torch, lambda: hash_embed_table_grad(ct, ids, rows)),
            "plain_ms": time_ms(torch, lambda: hash_embed_table_grad_plain(ct, ids, rows),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: torch.zeros(rows, D, device=dev).index_add_(
                0, flat, ct4), flush=flush),
            "bound_ms": bnd, "bound_by": by, "timer_floor_ms": floor_ms,
        }
        emit({"phase": "kernel:hash_embed_table_grad", **row})
        bwd.append(row)
    del scratch

    upd = []
    for name, leaf_set in leaf_sets:
        leaf_shapes = info[name]
        n_params = sum(math.prod(sh) for sh in leaf_shapes)
        P = [torch.randn(sh, device=dev, generator=g) for sh in leaf_shapes]
        G = [torch.randn(sh, device=dev, generator=g) * 1e-3 for sh in leaf_shapes]
        for grad in G:
            if grad.shape[0] == 262144:  # the BOW table: a microbatch touches few rows
                grad[torch.rand(grad.shape[0], device=dev, generator=g) > 0.01] = 0
        zero = info["zero_grad_leaves"].get(name, [])
        for i in zero:  # a frozen component's leaf: no gradient reaches it
            G[i].zero_()
        M = [torch.randn(sh, device=dev, generator=g) * 1e-4 for sh in leaf_shapes]
        V = [torch.rand(sh, device=dev, generator=g) * 1e-6 for sh in leaf_shapes]
        worst, worst_abs = 0, 0.0
        for hyper in (FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0),
                      FusedHyper("adam", 0.9, 0.999, 1e-8, 0.0, 0.01, 0.0),
                      FusedHyper("radam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.01)):
            gnorm = global_norm(G)
            sc = step_scalars(hyper, 9, 9, lambda s: 0.001)
            Pk, Mk, Vk = ([x.clone() for x in X] for X in (P, M, V))
            FusedUpdate(hyper).step(Pk, G, Mk, Vk, gnorm, sc)
            for i in range(len(P)):
                want = leaf_math_plain(P[i], G[i], M[i], V[i], gnorm, *sc, hyper=hyper)
                for a, w in zip((Pk[i], Mk[i], Vk[i]), want):
                    worst = max(worst, ulp_diff(torch, a, w))
                    worst_abs = max(worst_abs, (a - w).abs().max().item())
        if worst != 0:
            fail(f"K5 over {leaf_set}'s leaves: {worst} ulp from leaf_math_plain (want 0)")
        hyper = FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0)  # cnn.cfg's Adam.v1
        fused = FusedUpdate(hyper)
        gnorm = global_norm(G)
        sc = step_scalars(hyper, 9, 9, lambda s: 0.001)

        def plain_all():
            for p, gg, m, v in zip(P, G, M, V):
                leaf_math_plain(p, gg, m, v, gnorm, *sc, hyper=hyper)

        lib_params = [p.clone().requires_grad_(True) for p in P]
        for p, gg in zip(lib_params, G):
            p.grad = gg
        lib_opt = torch.optim.Adam(lib_params, lr=1e-3, fused=True)
        bnd, by = bound_ms(28 * n_params, 20 * n_params, PEAK_F32_FLOPS)
        row = {
            "leaf_set": leaf_set, "leaves": len(P), "params": n_params,
            "odd_sized_leaves": sum(math.prod(sh) % 4 != 0 for sh in leaf_shapes),
            "max_ulp": worst, "max_abs_err": worst_abs,
            "ms": time_ms(torch, lambda: fused.step(P, G, M, V, gnorm, sc)),
            "host_us": host_us(torch, lambda: fused.step(P, G, M, V, gnorm, sc)),
            "global_norm_ms": time_ms(torch, lambda: global_norm(G)),
            "plain_ms": time_ms(torch, plain_all, reps=10),
            "library_ms": time_ms(torch, lib_opt.step),
            "bound_ms": bnd, "bound_by": by, "timer_floor_ms": floor_ms,
            "dispatch": f"train:{name} step", "calls_per_dispatch": 1,
            "chunks": fused._table.shape[0], "zero_gradient_leaves": len(zero),
        }
        emit({"phase": "kernel:fused_update", **row})
        upd.append(row)
    return {"hash_embed_gather_sum": fwd, "hash_embed_table_grad": bwd, "fused_update": upd}


FLEET_STEPS, FLEET_EVAL = 40, 20  # train:fleet: cnn.cfg as 2 workers, quorum 2, S 0
FLEET_RESUME_STEPS = 5             # train:fleet:resume: its generation continued in this process
# train:fleet_async, the restart drill: JAX's defaults (quorum auto = 1, S 1)
# with --max-restarts 1 and a generation every 10 steps (evaluated on the
# first 16 dev docs); worker 1 SIGKILLed once a generation is committed and
# its version is >= 10. The lead steps on alone while the victim restarts
# (~10 s from the kill to its first accepted push on an H100), so it takes 300
FLEET_ASYNC_STEPS, FLEET_ASYNC_EVAL, FLEET_ASYNC_DEV_DOCS = 300, 10, 16
FLEET_ASYNC_VICTIM, FLEET_ASYNC_KILL_VERSION = 1, 10
FLEET_N = 2
# train:fleet_elastic: cnn.cfg as 3 workers at JAX's defaults (quorum auto = 2,
# S 1), --peer-lease-s 2; worker 2 SIGKILLed once every worker's version is
# >= 10. Eviction needs 3 missed probes 2 s apart (the worker's default
# lease_poll_s and miss threshold): 4-6 s, which 40 steps at tens of ms do
# not last, so the run takes 160 steps, evaluated every 40
FLEET_ELASTIC_N, FLEET_ELASTIC_VICTIM = 3, 2
FLEET_ELASTIC_STEPS, FLEET_ELASTIC_EVAL = 160, 40
FLEET_ELASTIC_LEASE_S, FLEET_LEASE_POLL_S, FLEET_LEASE_MISSES = 2.0, 2.0, 3
FLEET_ELASTIC_KILL_VERSION = 10
FLEET_ELASTIC_KILL_GENERATION = 40  # ... and once this step's generation is committed
# a SIGKILLed worker's listening socket outlives it while its CUDA context is
# torn down, and connections to it hang: a survivor's push blocks
# for the peer timeout, twice with the client's reconnect and twice again with
# the push's retry, and each liveness probe for the probe timeout. At the
# defaults (10 s, 5 s) a push could outlast the lead's remaining steps, so
# this run bounds them at 2 s and 1 s, and the eviction's bound counts each
# missed probe's timeout (ROADMAP C60)
FLEET_ELASTIC_PEER_TIMEOUT_S, FLEET_ELASTIC_PROBE_TIMEOUT_S = 2.0, 1.0
FLEET_ELASTIC_TAG_FLOOR = 0.95     # dev tag_acc at the last evaluation
FLEET_ELASTIC_AGREEMENT = 0.99     # the final model's tags, card vs CPU
# the fleets' wire: each run's flags, and the codec and delta window its
# workers must resolve (train:fleet_elastic runs the defaults: bf16 and 4 on
# the card); a push may weigh at most PUSH_RATIO_MAX of its f32 frame
FLEET_WIRE = {
    "train:fleet": (("--grad-compression", "f32", "--param-delta-window", "0"), "f32", 0),
    "train:fleet_async": (("--grad-compression", "int8", "--param-delta-window", "4"),
                          "int8", 4),
    "train:fleet_elastic": ((), "bf16", 4),
}
PUSH_RATIO_MAX = {"int8": 0.30, "bf16": 0.55}


def phase_fleet_kernels(torch, info):
    """K5 over the owner slices of the fleets: cnn.cfg's 26 leaves split by
    ``OwnershipLayout`` at N 2 (``train:fleet``, and the survivors of
    ``train:fleet_elastic`` after the re-shard) and at N 3 (its three
    owners before the kill), each owner's slices (contiguous copies, as an
    owner holds them) through the fused update with the clip link off (the
    worker clips) and through RAdam with decay, against ``leaf_math_plain``
    at ``MAXULP_K5``; timed beside the plain version,
    ``torch.optim.Adam(fused=True)`` and the bytes bound."""
    import numpy as np

    from spacy_ray_tpu_torch.ops.fused_update import (
        FusedHyper, FusedUpdate, global_norm, leaf_math_plain, step_scalars,
    )
    from spacy_ray_tpu_torch.training.fleet.ownership import OwnershipLayout, tree_from_flat

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    template = tree_from_flat({k: np.zeros(sh, np.float32)
                               for k, sh in info["cnn_paths"].items()})
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(1))
    rows = []
    for n, w in [(n, w) for n in (FLEET_N, FLEET_ELASTIC_N) for w in range(n)]:
        layout = OwnershipLayout(template, n)
        slices = layout.flat_slices(template, w)
        shapes = [v.shape for v in slices.values()]
        n_params = sum(math.prod(sh) for sh in shapes)
        P = [torch.randn(sh, device=dev, generator=g) for sh in shapes]
        G = [torch.randn(sh, device=dev, generator=g) * 1e-3 for sh in shapes]
        M = [torch.randn(sh, device=dev, generator=g) * 1e-4 for sh in shapes]
        V = [torch.rand(sh, device=dev, generator=g) * 1e-6 for sh in shapes]
        worst, worst_abs = 0, 0.0
        owner = FusedHyper("adam", 0.9, 0.999, 1e-8, 0.0, 0.0, 0.0)  # cnn.cfg's, clip off
        for hyper in (owner, FusedHyper("radam", 0.9, 0.999, 1e-8, 0.0, 0.0, 0.01)):
            sc = step_scalars(hyper, 9, 9, lambda s: 0.001)
            Pk, Mk, Vk = ([x.clone() for x in X] for X in (P, M, V))
            FusedUpdate(hyper).step(Pk, G, Mk, Vk, None, sc)
            for i in range(len(P)):
                want = leaf_math_plain(P[i], G[i], M[i], V[i], None, *sc, hyper=hyper)
                for a, b in zip((Pk[i], Mk[i], Vk[i]), want):
                    worst = max(worst, ulp_diff(torch, a, b))
                    worst_abs = max(worst_abs, (a - b).abs().max().item())
        if worst > MAXULP_K5:
            fail(f"K5 over owner {w} of {n}'s slices: {worst} ulp from leaf_math_plain "
                 f"(> {MAXULP_K5})")
        fused = FusedUpdate(owner)
        sc = step_scalars(owner, 9, 9, lambda s: 0.001)

        def plain_all():
            for p, gg, m, v in zip(P, G, M, V):
                leaf_math_plain(p, gg, m, v, None, *sc, hyper=owner)

        lib_params = [p.clone().requires_grad_(True) for p in P]
        for p, gg in zip(lib_params, G):
            p.grad = gg
        lib_opt = torch.optim.Adam(lib_params, lr=1e-3, fused=True)
        bnd, by = bound_ms(28 * n_params, 20 * n_params, PEAK_F32_FLOPS)
        row = {
            "leaf_set": f"cnn.cfg owner {w} of {n} (OwnershipLayout slices)",
            "n_workers": n, "owner": w,
            "leaves": len(P), "params": n_params,
            "sharded_leaves": sum(layout.axes[i] is not None for i in range(len(layout.paths))
                                  if layout.owns(i, w)),
            "odd_sized_leaves": sum(math.prod(sh) % 4 != 0 for sh in shapes),
            "max_ulp": worst, "max_abs_err": worst_abs,
            "ms": time_ms(torch, lambda: fused.step(P, G, M, V, None, sc)),
            "host_us": host_us(torch, lambda: fused.step(P, G, M, V, None, sc)),
            "plain_ms": time_ms(torch, plain_all, reps=10),
            "library_ms": time_ms(torch, lib_opt.step),
            "bound_ms": bnd, "bound_by": by, "timer_floor_ms": floor_ms,
            "dispatch": ("train:fleet owner apply" if n == FLEET_N
                         else "train:fleet_elastic owner apply before the kill"),
            "calls_per_dispatch": 1, "chunks": fused._table.shape[0],
        }
        emit({"phase": "kernel:fused_update", **row})
        rows.append(row)
    return rows


def free_base_port(n: int) -> int:
    """A port p with p .. p + n - 1 free on 127.0.0.1."""
    import socket

    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            socks = []
            for k in range(1, n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    fail("no run of free ports for the fleet")


def start_fleet(phase: str, corpus, steps: int, quorum: int, staleness: int, *,
                n: int = FLEET_N, eval_every: int = FLEET_EVAL, extra=()) -> dict:
    """Start ``python -m spacy_ray_tpu_torch train configs/cnn.cfg
    --fleet-workers N --quorum Q --max-staleness S`` on ``corpus``, ``steps``
    steps and an evaluation every ``eval_every``, on a free base port."""
    import os

    work = WORK / phase.replace(":", "_")
    shutil.rmtree(work, ignore_errors=True)
    out = work / "out"
    port = free_base_port(n)
    cmd = [sys.executable, "-m", "spacy_ray_tpu_torch", "train", "configs/cnn.cfg",
           "--output", str(out), "--paths.train", str(corpus[0]), "--paths.dev", str(corpus[1]),
           "--training.max_steps", str(steps), "--training.eval_frequency", str(eval_every),
           "--fleet-workers", str(n), "--quorum", str(quorum),
           "--max-staleness", str(staleness), "--fleet-base-port", str(port), *extra]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
    return {"proc": proc, "t0": time.perf_counter(), "work": work, "out": out,
            "steps": steps, "quorum": quorum, "staleness": staleness, "port": port}


def read_streams(proc):
    """Threads that drain a fleet's stdout and stderr into lists while it
    runs (a full pipe would stall its workers): ``(streams, threads)``."""
    streams = {"stdout": [], "stderr": []}
    readers = [threading.Thread(target=lambda f=getattr(proc, k), acc=acc: acc.extend(f),
                                daemon=True) for k, acc in streams.items()]
    for th in readers:
        th.start()
    return streams, readers


def fleet_wire(phase: str, ledgers, stderr: str):
    """``(row, problems)`` of a fleet run's wire (``FLEET_WIRE[phase]``):
    each worker's resolved codec and window, the reason its
    ``fleet-wire-codec`` event gave, push and pull bytes a step and their
    ratios to the ``_uncompressed`` counters, the push and pull phase
    medians and the codec's within them. A problem unless every worker resolved the expected codec and
    window and the ratios hold: f32 pushes and pulls at exactly 1.0; a
    compressed codec's pushes at most ``PUSH_RATIO_MAX`` in each worker and
    the run's pulls below 1.0."""
    _, codec, window = FLEET_WIRE[phase]
    said = dict(re.findall(r"\[fleet-wire-codec\] worker (\d+): ([^\n]*)", stderr))
    problems, workers = [], []
    total = {n: 0 for n in ("wire_push_bytes", "wire_push_bytes_uncompressed",
                            "wire_pull_bytes", "wire_pull_bytes_uncompressed")}
    for led in ledgers:
        c, k = led["counters"], led["worker"]
        for n in total:
            total[n] += c[n]
        push = c["wire_push_bytes"] / max(c["wire_push_bytes_uncompressed"], 1)
        pull = c["wire_pull_bytes"] / max(c["wire_pull_bytes_uncompressed"], 1)
        if (led["grad_compression"], led["param_delta_window"]) != (codec, window):
            problems.append(f"worker {k} resolved {led['grad_compression']}, window "
                            f"{led['param_delta_window']}, not {codec}, {window}")
        if codec == "f32":
            if not c["wire_push_bytes"] == c["wire_push_bytes_uncompressed"] > 0:
                problems.append(f"worker {k}: f32 pushes at {push} of their f32 frames")
        elif not 0 < push <= PUSH_RATIO_MAX[codec]:
            problems.append(f"worker {k}: {codec} pushes at {push} of their f32 frames "
                            f"(bound {PUSH_RATIO_MAX[codec]})")
        steps = max(led["steps"], 1)
        workers.append({
            "worker": k, "codec": led["grad_compression"], "delta_window": led["param_delta_window"],
            "said": said.get(str(k)),
            "push_bytes_per_step": c["wire_push_bytes"] / steps,
            "pull_bytes_per_step": c["wire_pull_bytes"] / steps,
            "push_ratio": push, "pull_ratio": pull,
            "push_ms_median": statistics.median(led["phase_steps_s"]["push"]) * 1e3,
            "pull_ms_median": statistics.median(led["phase_steps_s"]["pull"]) * 1e3,
            # of them the codec's: encoding the pushes, decoding and merging the pulls
            "push_encode_ms_median": statistics.median(led["codec_steps_s"]["push_encode"]) * 1e3,
            "pull_decode_ms_median": statistics.median(led["codec_steps_s"]["pull_decode"]) * 1e3,
            # and the frames' CRC-32, pushed and pulled, timed apart from the codec
            "crc_ms_median": statistics.median(led["codec_steps_s"]["crc"]) * 1e3,
            "frames_crc_refused": led["frames_crc_refused"],
        })
    pull = total["wire_pull_bytes"] / max(total["wire_pull_bytes_uncompressed"], 1)
    push = total["wire_push_bytes"] / max(total["wire_push_bytes_uncompressed"], 1)
    if codec == "f32":
        if not total["wire_pull_bytes"] == total["wire_pull_bytes_uncompressed"] > 0:
            problems.append(f"f32 pulls at {pull} of their full frames")
    elif not 0 < pull < 1.0:
        problems.append(f"pulls at {pull} of their full frames: no delta frame served")
    missing = [led["worker"] for led in ledgers if str(led["worker"]) not in said]
    if missing:
        problems.append(f"workers {missing} logged no fleet-wire-codec event")
    return {"codec": codec, "delta_window": window, "push_ratio": push, "pull_ratio": pull,
            "per_worker": workers, **total}, problems


def phase_train_fleet(torch, phase: str, corpus, steps: int, quorum: int, staleness: int,
                      cnn_wps=None, cleanup: bool = True) -> dict:
    """``python -m spacy_ray_tpu_torch train configs/cnn.cfg --fleet-workers
    2 --quorum Q --max-staleness S`` as a subprocess on the card (two worker
    processes), ``steps`` steps, an evaluation every ``FLEET_EVAL``. Fails
    unless it exits 0, every gradient received was applied or discarded,
    K1 fwd, K1 bwd and K5 launched in each worker (its ledger), the lead's
    loss fell (the mean of its last 5 steps below the first 5's), both
    workers reach version ``steps`` with nothing discarded, failed or timed
    out, the lead's dev tag_acc is >= 0.9, and best-model/ answers through
    the serving path with tags equal to the CPU's on the same directory. Reports the wall seconds,
    each worker's per-phase medians (ms), wire bytes a step, peak memory
    and words/s beside ``train:cnn``'s, and the wire (:func:`fleet_wire`,
    whose problems fail it too). ``cleanup=False`` keeps its directory for
    the caller."""
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.training.corpus import Corpus

    from spacy_ray_tpu_torch.training.resilience import terminate_with_grace

    run = start_fleet(phase, corpus, steps, quorum, staleness, extra=FLEET_WIRE[phase][0])
    work, out = run["work"], run["out"]
    try:
        stdout, stderr = run["proc"].communicate(timeout=600)
    finally:  # SIGTERM first: the coordinator stops its workers
        terminate_with_grace(run["proc"], grace_s=150.0)
    wall_s = time.perf_counter() - run["t0"]
    if run["proc"].returncode != 0:
        fail(f"{phase}: the fleet exited {run['proc'].returncode}:\n{stdout[-3000:]}\n"
             f"{stderr[-6000:]}")
    ledgers = [json.loads((out / f"fleet-worker-{k}.json").read_text(encoding="utf8"))
               for k in range(FLEET_N)]
    problems = []
    need = ("hash_embed_gather_sum", "hash_embed_table_grad", "fused_update")
    for k, led in enumerate(ledgers):
        c = led["counters"]
        if c["grad_applied"] + c["grad_discarded"] != c["grad_received"]:
            problems.append(f"worker {k}: applied + discarded != received ({c})")
        missing = [n for n in need if not led["launches"].get(n)]
        if missing:
            problems.append(f"worker {k} launched no {missing}")
        if led["version"] != steps or led["steps"] != steps:
            problems.append(f"worker {k}: version {led['version']}, steps {led['steps']}")
        bad = {n: c[n] for n in ("grad_discarded", "push_failed", "apply_wait_timeouts",
                                 "pull_failed", "pull_wait_timeouts") if c[n]}
        if led["frames_crc_refused"]:
            bad["frames_crc_refused"] = led["frames_crc_refused"]
        if bad:
            problems.append(f"worker {k}: {bad}")
    losses = ledgers[0]["step_losses"]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        problems.append(f"the lead's loss did not fall ({first} -> {last})")
    wire, wire_problems = fleet_wire(phase, ledgers, stderr)
    problems += wire_problems
    dev = ledgers[0]["history"][-1]["other_scores"] if ledgers[0]["history"] else {}
    if not dev.get("tag_acc", 0) >= 0.9:
        problems.append(f"dev tag_acc {dev.get('tag_acc')} < 0.9")
    texts = [" ".join(eg.reference.words) for eg in Corpus(corpus[1])()
             if len(eg.reference.words) <= 100][:8]
    server = build_server([str(out / "best-model"), "--port", "0", "--max-batch", "4",
                           "--max-doc-len", "128"])
    try:
        _, sport = server.start()
        server.engine.start()
        answers = []
        for i in range(0, len(texts), 2):
            status, body = post(sport, texts[i:i + 2])
            if status != 200:
                fail(f"{phase}: best-model did not serve: {status} {body}")
            answers.append((None, texts[i:i + 2], body))
        server.request_shutdown()
        if server.wait() != 0:
            problems.append("serving best-model did not drain cleanly")
    finally:
        if server.engine.ready:
            server.engine.stop()
        server.httpd.server_close()
    served = card_vs_cpu(out / "best-model", answers)
    if served.get("tags") != 1.0:
        problems.append(f"best-model's served tags differ from the CPU's: {served}")
    words = sum(led["words_seen"] for led in ledgers)
    per_worker = []
    for led in ledgers:
        c = led["counters"]
        per_worker.append({
            "worker": led["worker"], "version": led["version"], "steps": led["steps"],
            "counters": c, "phase_s": led["phases"],
            "phase_ms_median": {p: statistics.median(v) * 1e3
                                for p, v in led["phase_steps_s"].items()},
            "phase_share": {p: v / max(sum(led["phases"].values()), 1e-12)
                            for p, v in led["phases"].items()},
            "wire_bytes_per_step": (c["wire_push_bytes"] + c["wire_pull_bytes"])
            / max(led["steps"], 1),
            "owner_apply_ms_per_apply": led["owner_apply_seconds"] * 1e3 / max(c["applies"], 1),
            "peak_memory_gb": (led["peak_memory_bytes"] or 0) / 1e9,
            "seconds": led["seconds"], "words_per_s": led["words_seen"] / led["seconds"],
            "launches": {n: v for n, v in led["launches"].items() if v},
        })
    res_row = {
        "phase": phase, "steps": steps, "quorum": quorum, "max_staleness": staleness,
        "workers": FLEET_N, "wall_s": wall_s, "words": words,
        "words_per_s": words / max(led["seconds"] for led in ledgers),
        "train_cnn_words_per_s": cnn_wps,
        "loss_first5": first, "loss_last5": last, "dev_scores": dev,
        "discarded": [led["counters"]["grad_discarded"] for led in ledgers],
        "apply_wait_timeouts": [led["counters"]["apply_wait_timeouts"] for led in ledgers],
        "pull_wait_timeouts": [led["counters"]["pull_wait_timeouts"] for led in ledgers],
        "card_vs_cpu": served, "wire": wire, "per_worker": per_worker,
        "launches": {n: sum(led["launches"].get(n, 0) for led in ledgers)
                     for n in ledgers[0]["launches"]},
        "problems": problems,
    }
    emit(res_row)
    if problems:
        fail(f"{phase}: " + "; ".join(problems))
    if cleanup:
        shutil.rmtree(work, ignore_errors=True)
    return res_row


def phase_fleet_resume(torch, out: Path, corpus) -> dict:
    """train:fleet:resume — ``train:fleet``'s final generation (step
    ``FLEET_STEPS``) continued by one process on the card: fails unless it
    is format 2 with ``opt_state-40.part0of2.npz`` and ``part1of2`` that
    digest-verify and assemble with no hole (``TrainCheckpoint.load`` of that
    step, no fallback), and ``train(resume=True)`` for ``FLEET_RESUME_STEPS``
    more steps starts at its step with the parts' count, launches K1 fwd, K1
    bwd and K5 (once a step), and commits a generation at step 45 whose count
    is 5 more. Prints the parts' bytes, the load and run seconds and the
    losses."""
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.serving.live.watcher import scan_intact_generations
    from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint, opt_file_names
    from spacy_ray_tpu_torch.training.loop import train

    phase, last = "train:fleet:resume", out / "last-model"
    meta = json.loads((last / "train_meta.json").read_text(encoding="utf8"))
    parts = opt_file_names(meta, FLEET_STEPS)
    want = [f"opt_state-{FLEET_STEPS}.part{k}of{FLEET_N}.npz" for k in range(FLEET_N)]
    if (meta.get("step"), meta.get("format"), meta.get("opt_shards"), parts) != (
            FLEET_STEPS, 2, FLEET_N, want):
        fail(f"{phase}: the final generation is {meta.get('step')}, format "
             f"{meta.get('format')}, parts {parts}")
    t = time.perf_counter()
    gen = TrainCheckpoint.load(last)
    load_s = time.perf_counter() - t
    if gen["step"] != FLEET_STEPS:  # a fallback: the newest generation did not verify
        fail(f"{phase}: loaded generation {gen['step']}, not {FLEET_STEPS}")
    count = int(gen["opt_state"]["count"])
    cfg = cnn_config("cnn", corpus)
    cfg["training"]["max_steps"] = FLEET_STEPS + FLEET_RESUME_STEPS
    cfg["training"]["eval_frequency"] = FLEET_RESUME_STEPS
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    _, result = train(cfg, out, device="cuda", resume=True, stdout_log=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = _cuda.launch_counts()
    after = TrainCheckpoint.load(last)
    problems = []
    if (result.final_step, len(result.step_losses)) != (FLEET_STEPS + FLEET_RESUME_STEPS,
                                                        FLEET_RESUME_STEPS):
        problems.append(f"ended at step {result.final_step} after "
                        f"{len(result.step_losses)} steps")
    if (after["step"], after["format"], int(after["opt_state"]["count"])) != (
            FLEET_STEPS + FLEET_RESUME_STEPS, 1, count + FLEET_RESUME_STEPS):
        problems.append(f"its generation: step {after['step']}, format {after['format']}, "
                        f"count {int(after['opt_state']['count'])} (from {count})")
    if launches.get("fused_update") != FLEET_RESUME_STEPS or not (
            launches.get("hash_embed_gather_sum") and launches.get("hash_embed_table_grad")):
        problems.append(f"launches {launches}")
    if not all(math.isfinite(x) for x in result.step_losses):
        problems.append(f"losses {result.step_losses}")
    row = {"phase": phase, "generation": FLEET_STEPS, "parts": parts,
           "part_bytes": [(last / n).stat().st_size for n in parts],
           "intact_generations": scan_intact_generations(last), "load_s": load_s,
           "count": count, "steps": FLEET_RESUME_STEPS, "final_step": result.final_step,
           "losses": result.step_losses, "seconds": seconds,
           "launches": {n: v for n, v in launches.items()}, "problems": problems}
    emit(row)
    if problems:
        fail(f"{phase}: " + "; ".join(problems))
    return row


def start_fleet_restart(corpus) -> dict:
    """train:fleet_async, the restart drill, started: :func:`start_fleet`
    with ``FLEET_WIRE``'s flags, ``--max-restarts 1``, ``FLEET_ASYNC_STEPS``
    steps and a generation every ``FLEET_ASYNC_EVAL`` (evaluated on the
    first ``FLEET_ASYNC_DEV_DOCS`` dev docs), its output drained, and a
    thread that SIGKILLs worker ``FLEET_ASYNC_VICTIM``'s process once a
    generation is committed and its /metrics version is >=
    ``FLEET_ASYNC_KILL_VERSION``."""
    import os
    import signal

    from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint
    from spacy_ray_tpu_torch.training.corpus import Corpus
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin

    phase, victim = "train:fleet_async", FLEET_ASYNC_VICTIM
    dev = WORK / "fleet_async_dev.spacy"
    write_docbin(dev, [eg.reference for eg in Corpus(corpus[1])()][:FLEET_ASYNC_DEV_DOCS])
    run = start_fleet(phase, (corpus[0], dev), FLEET_ASYNC_STEPS, 0, 1,
                      eval_every=FLEET_ASYNC_EVAL,
                      extra=("--max-restarts", "1", *FLEET_WIRE[phase][0]))
    proc, port, last = run["proc"], run["port"], run["out"] / "last-model"
    run["streams"], run["readers"] = read_streams(proc)
    killed = run["killed"] = {}

    def kill_when_ready():
        deadline = time.monotonic() + 300
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                version = get(port + victim, "/metrics")[1]["gauges"]["param_version"]
            except (OSError, ValueError, KeyError):
                version = -1
            committed = TrainCheckpoint.generation_stamps(last)
            if committed and version >= FLEET_ASYNC_KILL_VERSION:
                pid = fleet_worker_pid(proc.pid, victim)
                killed.update(wall=time.time(), at_s=time.perf_counter() - run["t0"],
                              version=version, committed=committed)
                os.kill(pid, signal.SIGKILL)
                return
            time.sleep(0.05)

    run["killer"] = threading.Thread(target=kill_when_ready, daemon=True)
    run["killer"].start()
    return run


def phase_train_fleet_restart(torch, run) -> dict:
    """train:fleet_async, the restart drill (:func:`start_fleet_restart`),
    seen to its end: fails unless the fleet exits 0 with one
    ``supervisor-restart``, the victim's one ``fleet-resume`` names a
    committed step and its version, its ledger (the restarted process's)
    says it resumed from that step, its first owner row reads ``opt_source``
    "checkpoint" at that version and launched K5 once per apply, applied +
    discarded <= received on both workers, each launched K1 fwd, K1 bwd and
    K5, the victim's loss fell after the rejoin (the mean of its last 5
    steps below its first 5's), a push of the victim's was accepted, and the
    wire (:func:`fleet_wire`: int8, pushes <= 0.30) holds. Prints the seconds
    from the kill to the victim's first accepted push, the kill's step, the
    resumed step and version, and each worker's counters and phase
    medians."""
    from spacy_ray_tpu_torch.training.resilience import terminate_with_grace

    phase, victim = "train:fleet_async", FLEET_ASYNC_VICTIM
    proc, out = run["proc"], run["out"]
    try:
        run["killer"].join(timeout=330)
        proc.wait(timeout=600)
    finally:  # SIGTERM first: the coordinator stops its supervisors' workers
        terminate_with_grace(proc, grace_s=150.0)
        for th in run["readers"]:
            th.join(timeout=10)
    wall_s = time.perf_counter() - run["t0"]
    stdout, stderr = "".join(run["streams"]["stdout"]), "".join(run["streams"]["stderr"])
    killed = run["killed"]
    if not killed:
        fail(f"{phase}: worker {victim} was never killed (exit {proc.returncode}):\n"
             f"{stdout[-3000:]}\n{stderr[-6000:]}")
    if proc.returncode != 0:
        fail(f"{phase}: the fleet exited {proc.returncode} after the kill:\n{stdout[-3000:]}\n"
             f"{stderr[-6000:]}")
    ledgers = [json.loads((out / f"fleet-worker-{k}.json").read_text(encoding="utf8"))
               for k in range(FLEET_N)]
    problems = []
    restarts = stderr.count("[supervisor-restart]")
    if restarts != 1:
        problems.append(f"{restarts} supervisor restarts")
    resumed = re.findall(rf"\[fleet-resume\] worker {victim} resumed from checkpoint step "
                         r"(\d+) \(shard version (\d+)\)", stderr)
    step_v, version_v = map(int, resumed[0]) if len(resumed) == 1 else (None, None)
    vled = ledgers[victim]
    first_row = vled["owner_epochs"][0]
    if step_v is None or step_v % FLEET_ASYNC_EVAL or step_v < killed["committed"][-1]:
        problems.append(f"the victim's fleet-resume events {resumed} (committed before the "
                        f"kill: {killed['committed']})")
    if (vled.get("resume"), vled.get("resumed_from")) != (True, step_v):
        problems.append(f"the victim's ledger: resume {vled.get('resume')}, resumed_from "
                        f"{vled.get('resumed_from')}")
    if (first_row["opt_source"], first_row["version_start"]) != ("checkpoint", version_v) or \
            not 0 < first_row["applies"] == first_row["k5_launches"]:
        problems.append(f"the victim's owner row {first_row}")
    need = ("hash_embed_gather_sum", "hash_embed_table_grad", "fused_update")
    for k, led in enumerate(ledgers):
        c = led["counters"]
        if c["grad_applied"] + c["grad_discarded"] > c["grad_received"]:
            problems.append(f"worker {k}: applied + discarded > received ({c})")
        missing = [n for n in need if not led["launches"].get(n)]
        if missing:
            problems.append(f"worker {k} launched no {missing}")
    losses = vled["step_losses"]
    rejoin = (statistics.mean(losses[:5]), statistics.mean(losses[-5:])) \
        if len(losses) >= 10 else None
    if rejoin is None or not rejoin[1] < rejoin[0]:
        problems.append(f"the victim's loss after the rejoin: {rejoin} over {len(losses)} steps")
    first_push = vled.get("first_accepted_push_at")
    if first_push is None:
        problems.append("no push of the victim's was accepted after its restart")
    wire, wire_problems = fleet_wire(phase, ledgers, stderr)
    problems += wire_problems
    row = {
        "phase": phase, "steps": FLEET_ASYNC_STEPS, "quorum": 0, "max_staleness": 1,
        "max_restarts": 1, "eval_every": FLEET_ASYNC_EVAL, "victim": victim, "wall_s": wall_s,
        "killed_at_s": killed["at_s"], "version_at_kill": killed["version"],
        "generations_at_kill": killed["committed"], "supervisor_restarts": restarts,
        "resumed_step": step_v, "resumed_version": version_v,
        "kill_to_first_accepted_push_s": (first_push - killed["wall"]
                                          if first_push is not None else None),
        "victim_loss_first5_last5_after_rejoin": rejoin, "victim_steps_after_rejoin": len(losses),
        "wire": wire,
        "per_worker": [{
            "worker": led["worker"], "steps": led["steps"], "version": led["version"],
            "resumed_from": led.get("resumed_from"), "counters": led["counters"],
            "owner_epochs": [{x: e[x] for x in ("epoch", "opt_source", "opt_step", "applies",
                                                "k5_launches", "version_start")}
                             for e in led["owner_epochs"]],
            "generations": led.get("generations"), "opt_parts": len(led.get("opt_parts", [])),
            "phase_ms_median": {n: statistics.median(v) * 1e3
                                for n, v in led["phase_steps_s"].items() if v},
            "launches": {n: v for n, v in led["launches"].items() if v},
        } for led in ledgers],
        "launches": {n: sum(led["launches"].get(n, 0) for led in ledgers)
                     for n in ledgers[0]["launches"]},
        "problems": problems,
    }
    emit(row)
    if problems:
        fail(f"{phase}: " + "; ".join(problems))
    shutil.rmtree(run["work"], ignore_errors=True)
    return row


def fleet_worker_pid(coordinator_pid: int, worker_id: int) -> int:
    """The pid of the coordinator's child running ``--fleet-worker-id K``."""
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            ppid = int(stat.read_text().rsplit(")", 1)[1].split()[1])
            argv = (stat.parent / "cmdline").read_bytes().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == coordinator_pid and b"--fleet-worker-id" in argv and \
                argv[argv.index(b"--fleet-worker-id") + 1] == str(worker_id).encode():
            return int(stat.parent.name)
    fail(f"no process of fleet worker {worker_id} under pid {coordinator_pid}")


def phase_train_fleet_elastic(torch, corpus, info, k5_rows, beside=None) -> dict:
    """``python -m spacy_ray_tpu_torch train configs/cnn.cfg --fleet-workers
    3 --peer-lease-s 2`` (quorum auto = 2, S 1; peer requests and probes
    bounded at ``FLEET_ELASTIC_PEER_TIMEOUT_S`` and
    ``FLEET_ELASTIC_PROBE_TIMEOUT_S``) as a subprocess on the card,
    ``FLEET_ELASTIC_STEPS`` steps evaluated every ``FLEET_ELASTIC_EVAL``;
    worker 2's process SIGKILLed once every worker's ``/metrics`` shows
    version >= ``FLEET_ELASTIC_KILL_VERSION`` and the generation of step
    ``FLEET_ELASTIC_KILL_GENERATION`` is committed. ``beside`` (a callable) runs
    in this thread while the fleet starts. Fails unless the coordinator
    exits 0 with ``fleet-degraded-success``; both survivors end at epoch 1,
    active [0, 1], quorum 1, with ``shards_adopted`` > 0; the acting lead
    counted the eviction and its ``evict`` row came within
    ``FLEET_ELASTIC_LEASE_S`` + 3 x (``FLEET_LEASE_POLL_S`` + the probe
    timeout) + one step of the kill; each survivor takes a step after its
    re-shard; each survivor's owner of epoch 1 holds the N 2 layout's slices
    (the shapes of the K5 rows at N 2) and launched K5 once per apply, at
    least once; applied + discarded <= received (a re-push before the
    quorum replaces the buffered one); the final generation's
    ``extra.fleet`` says epoch 1 and active [0, 1]; the last evaluation's
    ``tag_acc`` >= ``FLEET_ELASTIC_TAG_FLOOR``; and the final model tags the
    dev set on the card as on the CPU for >= ``FLEET_ELASTIC_AGREEMENT`` of
    the tokens; nor unless the wire (:func:`fleet_wire`: the defaults, bf16
    and a delta window of 4) holds its ratios. Prints per survivor the epoch,
    active set, quorum, counters, each phase's median ms before and after its
    re-shard, and the seconds from the kill to the ``evict`` row and to each
    ``apply`` row."""
    import os
    import signal

    import numpy as np

    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint
    from spacy_ray_tpu_torch.training.corpus import Corpus
    from spacy_ray_tpu_torch.training.fleet.membership import read_membership_ledger
    from spacy_ray_tpu_torch.training.fleet.ownership import OwnershipLayout, tree_from_flat
    from spacy_ray_tpu_torch.training.resilience import terminate_with_grace

    phase, n, victim = "train:fleet_elastic", FLEET_ELASTIC_N, FLEET_ELASTIC_VICTIM
    run = start_fleet(phase, corpus, FLEET_ELASTIC_STEPS, 0, 1, n=n,
                      eval_every=FLEET_ELASTIC_EVAL,
                      extra=("--peer-lease-s", str(FLEET_ELASTIC_LEASE_S),
                             "--training.fleet_peer_timeout_s", str(FLEET_ELASTIC_PEER_TIMEOUT_S),
                             "--training.fleet_probe_timeout_s",
                             str(FLEET_ELASTIC_PROBE_TIMEOUT_S), *FLEET_WIRE[phase][0]))
    proc, out, port = run["proc"], run["out"], run["port"]
    streams, readers = read_streams(proc)
    killed = {}
    gen_meta = out / "last-model" / f"train_meta-{FLEET_ELASTIC_KILL_GENERATION}.json"

    def kill_when_ready():
        deadline = time.monotonic() + 300
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                snaps = [get(port + k, "/metrics")[1] for k in range(n)]
                versions = [snap["gauges"]["param_version"] for snap in snaps]
            except (OSError, ValueError, KeyError):
                versions = []
            if len(versions) == n and min(versions) >= FLEET_ELASTIC_KILL_VERSION \
                    and gen_meta.exists():
                pid = fleet_worker_pid(proc.pid, victim)
                killed.update(wall=time.time(), at_s=time.perf_counter() - run["t0"],
                              versions=versions,
                              phase_s={k: sum(snap["phases"].values())
                                       for k, snap in enumerate(snaps)})
                os.kill(pid, signal.SIGKILL)
                return
            time.sleep(0.05)

    killer = threading.Thread(target=kill_when_ready, daemon=True)
    killer.start()
    try:
        beside_s = None
        if beside is not None:
            t = time.perf_counter()
            beside()
            beside_s = time.perf_counter() - t
        killer.join(timeout=330)
        proc.wait(timeout=600)
    finally:  # SIGTERM first: the coordinator stops its workers
        terminate_with_grace(proc, grace_s=150.0)
        for th in readers:
            th.join(timeout=10)
    wall_s = time.perf_counter() - run["t0"]
    stdout, stderr = "".join(streams["stdout"]), "".join(streams["stderr"])
    if not killed:
        fail(f"{phase}: worker {victim} was never killed (exit {proc.returncode}):\n"
             f"{stdout[-3000:]}\n{stderr[-6000:]}")
    if proc.returncode != 0 or "fleet-degraded-success" not in stderr:
        fail(f"{phase}: the fleet exited {proc.returncode} after the kill:\n{stdout[-3000:]}\n"
             f"{stderr[-6000:]}")
    survivors = [k for k in range(n) if k != victim]
    ledgers = {k: json.loads((out / f"fleet-worker-{k}.json").read_text(encoding="utf8"))
               for k in survivors}
    rows = read_membership_ledger(out / "fleet-membership.jsonl")
    evicts = [r for r in rows if r["event"] == "evict"]
    applies = {r["worker"]: r for r in rows if r["event"] == "apply"}
    problems = []
    if (out / f"fleet-worker-{victim}.json").exists():
        problems.append(f"the killed worker {victim} wrote a ledger")
    if len(evicts) != 1 or evicts[0]["evicted"] != [victim] or evicts[0]["active"] != survivors:
        problems.append(f"evict rows {evicts}")
    template = tree_from_flat({k: np.zeros(sh, np.float32)
                               for k, sh in info["cnn_paths"].items()})
    n2 = OwnershipLayout(template, len(survivors))
    step_s = max(statistics.median(sum(v[i] for v in led["phase_steps_s"].values())
                                   for i in range(led["steps"])) for led in ledgers.values())
    evict_s = evicts[0]["ts"] - killed["wall"] if evicts else None
    evict_bound_s = (FLEET_ELASTIC_LEASE_S + step_s + FLEET_LEASE_MISSES
                     * (FLEET_LEASE_POLL_S + FLEET_ELASTIC_PROBE_TIMEOUT_S))
    if evict_s is None or not 0 < evict_s <= evict_bound_s:
        problems.append(f"evict row {evict_s} s after the kill (bound {evict_bound_s:.2f} s)")
    per_worker = []
    for rank, k in enumerate(survivors):
        led, c = ledgers[k], ledgers[k]["counters"]
        apply_row = applies.get(k)
        e1 = [e for e in led["owner_epochs"] if e["epoch"] == 1]
        want = {key: list(v.shape) for key, v in n2.flat_slices(template, rank).items()}
        n2_row = next(r for r in k5_rows if r.get("n_workers") == len(survivors)
                      and r.get("owner") == rank)
        if (led["membership_epoch"], led["active"], led["quorum"]) != (1, survivors, 1):
            problems.append(f"worker {k}: epoch {led['membership_epoch']}, active "
                            f"{led['active']}, quorum {led['quorum']}")
        if apply_row is None or not c["shards_adopted"] > 0:
            problems.append(f"worker {k}: apply row {apply_row}, {c['shards_adopted']} adopted")
        if len(e1) != 1 or e1[0]["owned_shapes"] != want or len(want) != n2_row["leaves"] \
                or sum(math.prod(s) for s in want.values()) != n2_row["params"]:
            problems.append(f"worker {k}: its epoch-1 slices are not the N 2 layout's {e1}")
        elif not (e1[0]["applies"] > 0 and e1[0]["k5_launches"] == e1[0]["applies"]):
            problems.append(f"worker {k}: {e1[0]['applies']} applies after the re-shard, "
                            f"{e1[0]['k5_launches']} K5 launches")
        elif (e1[0]["opt_source"], e1[0]["opt_step"]) != ("checkpoint",
                                                           FLEET_ELASTIC_KILL_GENERATION):
            problems.append(f"worker {k}: its adopted moments came from {e1[0]['opt_source']} "
                            f"at {e1[0]['opt_step']}, not the generation of step "
                            f"{FLEET_ELASTIC_KILL_GENERATION}")
        # at quorum 2 of 3 with S 1 a sender's re-push before the quorum
        # replaces its buffered one (JAX's owner too), counted nowhere
        if c["grad_applied"] + c["grad_discarded"] > c["grad_received"]:
            problems.append(f"worker {k}: applied + discarded > received ({c})")
        at = apply_row["step"] if apply_row else led["steps"]
        if at >= led["steps"]:
            problems.append(f"worker {k}: no step after its re-shard (at step {at} of "
                            f"{led['steps']}; the kill at {killed['versions']})")
        # the steps done before the kill: their phase seconds sum to at most
        # what the worker's /metrics said at the kill
        step_totals = [sum(v[i] for v in led["phase_steps_s"].values())
                       for i in range(led["steps"])]
        done = list(itertools.accumulate(step_totals))
        before_kill = bisect.bisect_right(done, killed["phase_s"][k])
        windows = {"before_kill": (0, before_kill), "kill_to_reshard": (before_kill, at),
                   "after_reshard": (at, led["steps"])}
        per_worker.append({
            "worker": k, "epoch": led["membership_epoch"], "active": led["active"],
            "quorum": led["quorum"], "steps": led["steps"], "version": led["version"],
            "applied_at_step": at,
            **{name: c[name] for name in ("evictions", "shards_adopted", "epoch_fenced",
                                           "pull_failed", "push_failed", "grad_discarded",
                                           "apply_wait_timeouts", "pull_wait_timeouts")},
            "received_replaced_or_buffered": (c["grad_received"] - c["grad_applied"]
                                              - c["grad_discarded"]),
            "kill_to_apply_s": apply_row["ts"] - killed["wall"] if apply_row else None,
            "steps_before_kill": before_kill,
            "loss_mean_5_before_reshard": mean_or_none(led["step_losses"][max(at - 5, 0):at]),
            "loss_mean_5_after_reshard": mean_or_none(led["step_losses"][at:at + 5]),
            "losses_5_after_reshard": led["step_losses"][at:at + 5],
            "phase_ms_median": {name: {p: statistics.median(v[a:b]) * 1e3
                                       for p, v in led["phase_steps_s"].items()}
                                for name, (a, b) in windows.items() if b > a},
            "step_ms_median": {name: statistics.median(step_totals[a:b]) * 1e3
                               for name, (a, b) in windows.items() if b > a},
            "owner_epochs": [{x: e[x] for x in ("epoch", "quorum", "opt_source", "opt_step",
                                                "applies", "k5_launches", "version_start")}
                             for e in led["owner_epochs"]],
            "owner_apply_ms_per_apply": led["owner_apply_seconds"] * 1e3 / max(c["applies"], 1),
            "launches": {name: v for name, v in led["launches"].items() if v},
        })
    if not ledgers[survivors[0]]["counters"]["evictions"] >= 1:
        problems.append("the acting lead counted no eviction")
    wire, wire_problems = fleet_wire(phase, list(ledgers.values()), stderr)
    problems += wire_problems
    gen = TrainCheckpoint.load(out / "last-model")
    gen_fleet = (gen or {}).get("extra", {}).get("fleet") or {}
    if (gen_fleet.get("epoch"), gen_fleet.get("active")) != (1, survivors):
        problems.append(f"the final generation's extra.fleet {gen_fleet}")
    history = ledgers[survivors[0]]["history"]
    dev = history[-1]["other_scores"] if history else {}
    if not dev.get("tag_acc", 0) >= FLEET_ELASTIC_TAG_FLOOR:
        problems.append(f"dev tag_acc {dev.get('tag_acc')} < {FLEET_ELASTIC_TAG_FLOOR}")
    texts = [" ".join(eg.reference.words) for eg in Corpus(corpus[1])()][:64]
    tags = {}
    for device in ("cuda", "cpu"):
        nlp = Pipeline.from_disk(out / "last-model", device=device)
        docs = [nlp.tokenizer(t) for t in texts]
        nlp.predict_docs(docs)
        tags[device] = [t for d in docs for t in d.tags]
        del nlp
    agree = sum(a == b for a, b in zip(tags["cuda"], tags["cpu"])) / max(len(tags["cpu"]), 1)
    if not agree >= FLEET_ELASTIC_AGREEMENT:
        problems.append(f"the final model's tags agree with the CPU's for {agree}")
    res_row = {
        "phase": phase, "workers": n, "steps": FLEET_ELASTIC_STEPS, "quorum": 0,
        "max_staleness": 1, "peer_lease_s": FLEET_ELASTIC_LEASE_S, "victim": victim,
        "wall_s": wall_s, "beside_s": beside_s, "killed_at_s": killed["at_s"],
        "versions_at_kill": killed["versions"], "kill_to_evict_s": evict_s,
        "evict_bound_s": evict_bound_s, "step_s_median": step_s,
        "kill_to_apply_s": {k: w["kill_to_apply_s"] for k, w in zip(survivors, per_worker)},
        "evict_rows": evicts, "final_generation_fleet": gen_fleet,
        "dev_scores": dev, "final_model_tags_card_vs_cpu": agree, "dev_tokens": len(tags["cpu"]),
        "wire": wire, "per_worker": per_worker,
        "launches": {name: sum(led["launches"].get(name, 0) for led in ledgers.values())
                     for name in ledgers[survivors[0]]["launches"]},
        "problems": problems,
    }
    emit(res_row)
    if problems:
        fail(f"{phase}: " + "; ".join(problems) + f"\nthe fleet's stderr:\n{stderr[-12000:]}")
    shutil.rmtree(run["work"], ignore_errors=True)
    return res_row


def head_losses_fell(result, heads, phase):
    """Each head's mean loss over the first and last 5 steps; fails unless
    the last is at most 2/3 of the first."""
    out = {}
    for head in heads:
        xs = [step[head] for step in result.step_head_losses]
        if not xs or not all(math.isfinite(x) for x in xs):
            fail(f"{phase}: loss_{head} is not finite: {xs}")
        first, last = statistics.mean(xs[:5]), statistics.mean(xs[-5:])
        out[head] = {"first5_mean": first, "last5_mean": last, "first": xs[0], "last": xs[-1]}
        if not last <= 2 / 3 * first:
            fail(f"{phase}: loss_{head} fell from {first} to only {last} (> 2/3)")
    return out


def grad_check(torch, nlp, cfg, c, keys=None):
    """Every trained leaf's gradient on microbatch ``c`` with the kernels
    against the plain versions ({leaf: max |g - g_plain| / max |g_plain|}),
    and the control: what leaving out one typical row's adds (K1 bwd) would
    read on the same measure, the median over a table's touched rows of
    max |g_row| / max |g|, at its least over the tables; the limit must sit
    below it. A row is touched if its gradient is not zero, or, with
    ``keys`` (hash keys [N, attributes, 2]), if one of those tokens hashes
    to it."""
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids

    nlp.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()
              if p.requires_grad}
    plain = {}
    rel = grad_errs_vs_plain(torch, nlp, params, c, plain_out=plain)
    row_drop = []
    for k, g in plain.items():
        if k.endswith("/E"):
            touched = None
            if keys is not None:
                table = nlp.model.get_submodule(k[:-2].replace("/", "."))
                ids = hash_embed_ids(keys[:, table.attr_index], table.seed,
                                     table.dims["rows"])
                touched = torch.unique(ids.long())
            row_drop.append(table_row_share(g, touched))
    return rel, min(row_drop)


def table_row_share(g, touched=None) -> float:
    """The median over a table gradient's touched rows (the ids
    ``touched``, or the rows that are not zero) of max |g_row| / max |g|:
    what leaving out one typical row's adds would read."""
    rows = g.abs().amax(dim=1)
    if touched is not None:
        rows = rows[touched]
    rows = rows[rows > 0]
    return (rows.median() / g.abs().max()).item()


def nel_grad_probe(torch, nlp, cfg, c):
    """``train:nel``'s gradient check: the linker at the loop's starting
    weights (a fresh ``initialize`` of the same config), where every mention
    has a gradient (trained, it is sure of the train set and its gradient
    sits on a few rows); its loss reads only its mentions' tokens, so the
    control takes the rows those tokens hash to."""
    from spacy_ray_tpu_torch import Pipeline

    fresh = Pipeline.from_config(cfg, device="cuda")
    fresh.initialize(seed=int(cfg["training"].get("seed") or 0))
    t = c["targets"]["entity_linker"]
    pos = torch.arange(c["tokens"].attr_keys.shape[1], device=t["nel_start"].device)
    inside = ((pos >= t["nel_start"][..., None]) & (pos < t["nel_end"][..., None])
              & t["nel_mask"][..., None]).any(dim=1)  # [B, T] tokens inside a mention
    return grad_check(torch, fresh, cfg, c, keys=c["tokens"].attr_keys[inside])


#: what each CNN phase trains, as its result line names it
CNN_PHASE_CONFIGS = {
    "cnn": "configs/cnn.cfg as written",
    "sm": "configs/sm.cfg as written",
    "spancat": "configs/spancat.cfg as written",
    "textcat": "spaCy's default textcat (TextCatEnsemble.v2: cnn.cfg's tok2vec inline + "
               "TextCatBOW.v3, 262144 rows) with cnn.cfg's [training]",
    "tokcls": "configs/cnn.cfg as written + morphologizer, senter, trainable_lemmatizer "
              "(Tagger.v2 heads over listeners)",
    "md": "spaCy's md layout from configs/sm.cfg: Tok2Vec.v2 (MultiHashEmbed.v2 rows "
          "5000/1000/2500/2500 with static vectors, 20000 x 300 from a seed; encoder depth 4), "
          "tagger, parser (hidden 64), attribute_ruler (TAG -> POS), rule lemmatizer, ner "
          "(hidden 64, its own trunk alike), entity_ruler; sm.cfg's [training]",
    "nel": "train:md's best-model with every component sourced and frozen, the ner "
           "annotating, and an entity_linker (8 candidates, priors on, trained on the ner's "
           "mentions) over its own HashEmbedCNN.v2 (width 96, depth 2, embed_size 2000, "
           "window 1, 3 pieces: spaCy's nel_emerson trunk); before_update recorded; sm.cfg's "
           "[training] scored by nel_micro_f",
}


def phase_train_cnn(torch, name, cfg, leaf_shapes, grad_probe=None, floors=None):
    """``train()`` on ``cfg`` (``pipeline_config(name)``: ``max_steps`` and
    ``eval_frequency`` cut) over its .spacy corpus, launch counters zeroed
    just before and read just after; each trained head's loss must fall to
    <= 2/3 and the dev scores must hold ``floors`` (``DEV_FLOORS[name]``
    unless given); then, on its first microbatch, the step under the
    profiler (the card's idle share over 5 steps, top kernels, launches),
    the device operations of a microbatch with the hash ids' share, the
    host's featurize + collate time, and every trained leaf's gradient with
    the kernels against the plain versions (dropout off): ``grad_check`` on
    the trained pipeline, or ``grad_probe(torch, nlp, cfg, microbatch)``
    where it is given."""
    from torch.profiler import ProfilerActivity, profile

    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids
    from spacy_ray_tpu_torch.models.layers import HashEmbed
    from spacy_ray_tpu_torch.pipeline.doc import Example
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length
    from spacy_ray_tpu_torch.training.loop import train

    phase = f"train:{name}"
    work = WORK / f"train_{name}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg["training"]["max_steps"] = CNN_STEPS
    cfg["training"]["eval_frequency"] = CNN_EVAL
    out = work / "out"

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    nlp, result = train(cfg, out, device="cuda", stdout_log=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    missing = [k for k in ("hash_embed_gather_sum", "hash_embed_table_grad", "fused_update")
               if launches[k] == 0]
    if missing:
        fail(f"{phase}: kernels never launched on the training path: {missing}")
    if len(result.step_head_losses) != CNN_STEPS:
        fail(f"{phase}: {len(result.step_head_losses)} steps' losses, expected {CNN_STEPS}")
    heads = [n for n in nlp.head_names()
             if nlp.components[n].trainable and n not in nlp.frozen_components]
    head_losses = head_losses_fell(result, heads, phase)
    trained = [tuple(p.shape) for p in nlp.model.parameters()]
    if trained != leaf_shapes:
        fail(f"{phase}: trained {len(trained)} leaves, not the {len(leaf_shapes)} K5 was held at")
    event_ms = [a.elapsed_time(b) for a, b in result.step_events]
    last = result.history[-1]["other_scores"]
    floors = DEV_FLOORS.get(name, {}) if floors is None else floors
    low = {k: last.get(k) for k, floor in floors.items() if not (last.get(k) or 0) >= floor}
    if low:
        fail(f"{phase}: dev scores at step {result.history[-1]['step']} below their "
             f"floors {floors}: {low}")

    cfg_i = cfg.interpolate()
    batcher = registry.resolve(cfg_i["training"]["batcher"])
    batch = next(iter(batcher(registry.resolve(cfg_i["corpora"]["train"])())))
    B_pad, T_pad = bucket_batch_size(len(batch)), bucket_length(max(len(eg) for eg in batch))
    if nlp.annotating_components:  # the loop's annotating pass (train:nel's NER mentions)
        shells = [eg.reference.copy_shell() for eg in batch]
        nlp.predict_docs(shells, annotate=nlp.annotating_components)
        for eg, shell in zip(batch, shells):
            eg.predicted = shell
    c = nlp.collate(batch, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
    # the featurize + collate of one microbatch, its copy to the card
    # included: fresh Examples (their keys hashed) and the same Examples
    # again (the feature cache)
    fresh = [Example.from_gold(eg.reference) for eg in batch]
    collate_ms = {}
    for label, egs in (("uncached", fresh), ("cached", fresh)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nlp.collate(egs, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
        torch.cuda.synchronize()
        collate_ms[label] = (time.perf_counter() - t) * 1e3
    vector_rows_ms = None
    if nlp.vectors is not None:  # the vector rows' share: their lookups alone
        fresh = [Example.from_gold(eg.reference) for eg in batch]
        vector_rows_ms = {}
        for label in ("uncached", "cached"):
            t = time.perf_counter()
            for eg in fresh:
                nlp._vector_rows(eg)
            vector_rows_ms[label] = (time.perf_counter() - t) * 1e3

    nlp.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}
    # a frozen component's leaves take no gradient: K5 gets zeros for them
    zeros = {k: torch.zeros_like(p) for k, p in params.items() if not p.requires_grad}
    optimizer = registry.resolve(cfg_i["training"]["optimizer"])
    opt_state = optimizer.init(params)

    def fwd_bwd():
        for p in params.values():
            p.grad = None
        nlp.loss(c["tokens"], c["targets"], dropout=0.1, seed=1)[0].backward()

    def step():  # the loop's step: the collate (cached keys), fwd + bwd, K5
        b = nlp.collate(batch, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
        for p in params.values():
            p.grad = None
        nlp.loss(b["tokens"], b["targets"], dropout=0.1, seed=1)[0].backward()
        with torch.no_grad():
            optimizer.update(params, {k: zeros.get(k, p.grad) for k, p in params.items()},
                             opt_state)

    ops = device_ops(torch, fwd_bwd)
    tables = [(m.dims["rows"], m.seed, m.attr_index)
              for m in nlp.model.modules() if isinstance(m, HashEmbed)]
    keys = c["tokens"].attr_keys
    ids_ops = device_ops(torch, lambda: [hash_embed_ids(keys[..., a, :], s, r)
                                         for r, s, a in tables])
    n_ops = sum(v[0] for v in ops.values())
    n_ids = sum(v[0] for v in ids_ops.values())

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    launch_calls = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    table_grad_kernels = sum(e.count for e in events if "table_grad_pieces" in e.key)
    top = sorted(events, key=dev_us, reverse=True)[:10]
    host_ops = sorted((e for e in prof.key_averages()
                       if not str(getattr(e, "device_type", "")).endswith("CUDA")),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:8]

    rel, control = (grad_probe or grad_check)(torch, nlp, cfg_i, c)
    worst_leaf = max(rel, key=rel.get)
    if not rel[worst_leaf] <= TOL_GRAD_CNN:
        fail(f"{phase}: gradient of {worst_leaf} kernels vs plain {rel[worst_leaf]} "
             f"> {TOL_GRAD_CNN}")
    if not control > TOL_GRAD_CNN:
        fail(f"{phase}: a dropped table row would read {control}, not above {TOL_GRAD_CNN}")
    nlp.requires_grad_(False)
    md = md_train_checks(torch, nlp, out, cfg_i, result) if name == "md" else None
    nel = (nel_train_checks(torch, nlp, out, cfg_i, result, launches, table_grad_kernels)
           if name == "nel" else None)
    oracle = (dict(nlp.components["parser"].oracle_stats) if "parser" in nlp.components
              else None)
    del nlp, params, zeros, optimizer, opt_state, c
    torch.cuda.empty_cache()

    keys_s = ("tag_acc", "dep_uas", "dep_las", "ents_f", "spans_sc_f", "cats_micro_f",
              "cats_macro_auc", "cats_score", "pos_acc", "morph_acc", "lemma_acc", "sents_f",
              "nel_micro_p", "nel_micro_r", "nel_micro_f")
    res = {
        "phase": phase, "config": f"{CNN_PHASE_CONFIGS[name]}; max_steps {CNN_STEPS}, "
        f"eval_frequency {CNN_EVAL} (cut); corpora .spacy (via the port's writer)",
        "dev_floors": floors,
        "seconds": seconds, "steps": result.final_step, "leaves": len(leaf_shapes),
        "params": sum(math.prod(sh) for sh in leaf_shapes),
        "group_shapes_B_T": sorted(set(result.step_shapes)), "head_losses": head_losses,
        "dev_scores": [(h["step"], {k: h["other_scores"].get(k) for k in keys_s
                                    if k in h["other_scores"]}) for h in result.history],
        "step_ms_median_events": statistics.median(event_ms),
        "step_ms_median_host": statistics.median(x * 1e3 for x in result.step_host_seconds),
        # the annotating pass (its predictions synchronise), outside the step
        "annotate_ms_median_host": (statistics.median(x * 1e3 for x in result.annotate_seconds)
                                    if result.annotate_seconds else None),
        # every step in order: the first epoch's collates hash the keys and
        # run the oracle, the later ones read the Examples' caches
        "step_ms_quartiles_events": statistics.quantiles(event_ms, n=4),
        "step_ms_events": event_ms,
        "words_per_s": result.wps, "words": result.words_seen,
        "peak_memory_gb": peak_gb, "launches": launches, "oracle": oracle,
        "microbatch_B_T": [B_pad, T_pad],
        "microbatch_fwd_bwd_device_ops": n_ops,
        "microbatch_fwd_bwd_kernel_ms": sum(v[1] for v in ops.values()),
        "hash_ids_device_ops": n_ids, "hash_ids_share_of_ops": n_ids / max(n_ops, 1),
        "top_ops_fwd_bwd": sorted(ops.items(), key=lambda kv: -kv[1][0])[:8],
        "collate_ms_with_copy": collate_ms, "vector_rows_ms": vector_rows_ms,
        "step_profile": {
            "steps": PROFILE_STEPS, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "cuda_launch_kernel_calls_per_step": launch_calls / PROFILE_STEPS,
            "table_grad_kernels_per_step": table_grad_kernels / PROFILE_STEPS,
            "top_device_ms": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in top],
            "top_host_self_ms": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                                 for e in host_ops],
        },
        "grad_max_rel_err": rel[worst_leaf], "grad_worst_leaf": worst_leaf,
        "grad_tol": TOL_GRAD_CNN, "grad_control_row_drop": control,
    }
    if md is not None:
        res["md"] = md
    if nel is not None:
        res["nel"] = nel
    emit(res)
    return res, out / "best-model"


def md_train_checks(torch, nlp, out: Path, cfg, result) -> dict:
    """What ``train:md`` adds to a CNN phase: the two frozen tables
    bit-equal to the vectors file after training, in the model and in the
    saved ``params.npz`` files; the leaves the loop hands K5 (no frozen
    table among them) and an opt-state file without frozen entries; dev
    ``lemma_acc`` against what the same lemmatizer scores from gold POS
    (``LEMMA_FLOOR_OF_GOLD_POS``); the time of one checkpoint generation's
    save (what ``save_last`` writes at every evaluation) and its bytes."""
    import numpy as np

    from spacy_ray_tpu_torch.models.core import param_paths
    from spacy_ray_tpu_torch.pipeline.doc import Doc, Example
    from spacy_ray_tpu_torch.pipeline.vectors import Vectors
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint, load_params
    from spacy_ray_tpu_torch.training.corpus import Corpus
    from spacy_ray_tpu_torch.training.loop import _named_params

    table = Vectors.from_disk(cfg["initialize"]["vectors"]).table
    paths = param_paths(nlp.model)
    frozen = sorted(k for k in paths if k.endswith("frozen_table"))
    if frozen != ["ner/tok2vec/0_multi_hash_embed/0_embeds/4_static_vectors/frozen_table",
                  "tok2vec/0_multi_hash_embed/0_embeds/4_static_vectors/frozen_table"]:
        fail(f"train:md: frozen tables at {frozen}, not at the JAX package's paths")
    stamp = result.final_step
    saved = {"best-model": load_params(out / "best-model" / "params.npz"),
             "last-model": load_params(out / "last-model" / f"params-{stamp}.npz")}
    for k in frozen:
        if not torch.equal(paths[k].cpu(), torch.from_numpy(table)):
            fail(f"train:md: {k} changed in training")
        for where, flat in saved.items():
            if not np.array_equal(flat[k], table):
                fail(f"train:md: {where}'s {k} differs from the vectors file")
    leaves = _named_params(nlp)
    opt = load_params(out / "last-model" / f"opt_state-{stamp}.npz")
    if any("frozen" in k for k in list(leaves) + list(opt)) or \
            len(opt) != 2 * len(leaves) + 2:
        fail(f"train:md: K5's {len(leaves)} leaves or the opt state's {len(opt)} entries "
             "hold a frozen table")

    lem = nlp.components["lemmatizer"]
    gold = list(Corpus(cfg["paths"]["dev"])())
    shells = [Doc(words=list(eg.reference.words), pos=list(eg.reference.pos)) for eg in gold]
    lem.set_annotations(shells, None, [len(d) for d in shells])
    ceiling = lem.score([Example(d, eg.reference) for d, eg in zip(shells, gold)])["lemma_acc"]
    lemma_acc = result.history[-1]["other_scores"]["lemma_acc"]
    if not lemma_acc >= LEMMA_FLOOR_OF_GOLD_POS * ceiling:
        fail(f"train:md: lemma_acc {lemma_acc} < {LEMMA_FLOOR_OF_GOLD_POS} x {ceiling}, "
             "the rule lemmatizer's score from gold POS")

    optimizer = registry.resolve(cfg["training"]["optimizer"])
    opt_state = optimizer.init(leaves)
    ckpt = WORK / "md_save"
    shutil.rmtree(ckpt, ignore_errors=True)
    save_ms = []
    for step in range(1, 4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        TrainCheckpoint.save(ckpt, params=param_paths(nlp.model), opt_state=opt_state,
                             step=step, epoch=0, best_score=0.0, best_step=0, keep=2)
        save_ms.append((time.perf_counter() - t) * 1e3)
    params_bytes = (ckpt / "params-3.npz").stat().st_size
    opt_bytes = (ckpt / "opt_state-3.npz").stat().st_size
    shutil.rmtree(ckpt, ignore_errors=True)
    return {
        "frozen_tables": frozen, "frozen_tables_bit_equal_after_training": True,
        "frozen_table_shape": list(table.shape),
        "k5_leaves": len(leaves), "k5_params": sum(p.numel() for p in leaves.values()),
        "opt_state_entries": len(opt),
        "lemma_acc": lemma_acc, "lemma_acc_from_gold_pos": ceiling,
        "lemma_floor": LEMMA_FLOOR_OF_GOLD_POS * ceiling,
        "checkpoint_save_ms": save_ms, "params_file_bytes": params_bytes,
        "frozen_bytes": 2 * table.nbytes, "opt_state_file_bytes": opt_bytes,
    }


def nel_train_checks(torch, nlp, out: Path, cfg, result, launches, table_grad_kernels) -> dict:
    """What ``train:nel`` adds to a CNN phase: every frozen component's
    parameters and both frozen tables bit-equal to the source's after
    training, in the model, ``best-model/`` and the last generation; dev
    ``ents_f``, ``tag_acc`` and ``dep_las`` equal to the source model's own
    on the same dev set; the linker's dev ``nel_micro_f`` at least the
    prior-only baseline + ``NEL_OVER_PRIOR`` (beside ``DEV_FLOORS["nel"]``,
    reported: see ``train_nel_shared``);
    ``before_update`` called once a step, steps 0, 1, ... in order; K1 bwd
    launched for the linker's 4 tables only (the loop's count and the
    profiled steps' kernels)."""
    import numpy as np

    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.models.core import param_paths
    from spacy_ray_tpu_torch.training.checkpoint import load_params
    from spacy_ray_tpu_torch.training.corpus import Corpus

    work = Path(cfg["components"]["entity_linker"]["kb_path"]).parent  # nel_assets' dir
    src_dir = Path(nlp.sourced_components["tok2vec"])
    src = load_params(src_dir / "params.npz")
    paths = param_paths(nlp.model)
    frozen = sorted(k for k in paths if k.split("/")[0] in nlp.frozen_components)
    if set(frozen) != set(src):
        fail(f"train:nel: {len(frozen)} frozen leaves, the source has {len(src)}")
    stamp = result.final_step
    saved = {"best-model": load_params(out / "best-model" / "params.npz"),
             "last-model": load_params(out / "last-model" / f"params-{stamp}.npz")}
    for k in frozen:
        if not torch.equal(paths[k].cpu(), torch.from_numpy(src[k])):
            fail(f"train:nel: frozen {k} changed in training")
        for where, flat in saved.items():
            if not np.array_equal(flat[k], src[k]):
                fail(f"train:nel: {where}'s frozen {k} differs from the source")
    dev = list(Corpus(cfg["paths"]["dev"])())
    source_scores = Pipeline.from_disk(src_dir, device="cuda").evaluate(dev)
    last = result.history[-1]["other_scores"]
    same = {k: (last[k], source_scores[k]) for k in ("ents_f", "tag_acc", "dep_las")}
    if any(a != b for a, b in same.values()):
        fail(f"train:nel: frozen components' dev scores differ from the source's: {same}")
    baseline = json.loads((work / "counts.json").read_text())["prior_only_dev_nel_micro_f"]
    if not last["nel_micro_f"] >= baseline + NEL_OVER_PRIOR:
        fail(f"train:nel: dev nel_micro_f {last['nel_micro_f']} < the prior-only decode's "
             f"{baseline} + {NEL_OVER_PRIOR}")
    steps = [s for s, _ in STEP_CALLS]
    epochs = [e for _, e in STEP_CALLS]
    if steps != list(range(stamp)) or epochs != sorted(epochs):
        fail(f"train:nel: before_update calls {STEP_CALLS[:5]}... are not steps 0..{stamp - 1}")
    linker_tables = 4
    if launches["hash_embed_table_grad"] != linker_tables * stamp \
            or table_grad_kernels != linker_tables * PROFILE_STEPS:
        fail(f"train:nel: K1 bwd launched {launches['hash_embed_table_grad']} times in "
             f"{stamp} steps and {table_grad_kernels} kernels in {PROFILE_STEPS} profiled "
             f"steps: a frozen trunk took a table gradient")
    return {"frozen_leaves_bit_equal": len(frozen), "source": str(src_dir.relative_to(ROOT)),
            "frozen_components": nlp.frozen_components, "dev_vs_source": same,
            "nel_micro_f": last["nel_micro_f"], "nel_over_prior_floor": baseline + NEL_OVER_PRIOR,
            "nel_floor": DEV_FLOORS["nel"]["nel_micro_f"],
            "nel_floor_reached": last["nel_micro_f"] >= DEV_FLOORS["nel"]["nel_micro_f"],
            "prior_only_dev_nel_micro_f": baseline,
            "before_update_calls": len(STEP_CALLS), "epochs_seen": sorted(set(epochs)),
            "table_grad_launches": launches["hash_embed_table_grad"],
            "table_grad_kernels_in_profiled_steps": table_grad_kernels}


def train_nel_shared(torch, cfg, baseline: float) -> dict:
    """``train()`` on ``cfg`` (``nel_config`` over ``nel_assets(shared=True)``'s
    KB: train:nel's layout, seed and corpora), launch counters zeroed just
    before and read just after, evaluated once at the last step; fails
    unless dev ``nel_micro_f`` is at least ``DEV_FLOORS["nel"]`` and the
    prior-only decode's ``baseline`` + ``NEL_OVER_PRIOR``."""
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.training.loop import train

    cfg["training"].update(max_steps=CNN_STEPS, eval_frequency=CNN_STEPS)
    STEP_CALLS.clear()
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    _, result = train(cfg, None, device="cuda", stdout_log=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    f = result.history[-1]["other_scores"]["nel_micro_f"]
    floor = max(DEV_FLOORS["nel"]["nel_micro_f"], baseline + NEL_OVER_PRIOR)
    if not f >= floor:
        fail(f"train:nel_shared: dev nel_micro_f {f} < {floor} (floor "
             f"{DEV_FLOORS['nel']['nel_micro_f']}, prior-only {baseline} + {NEL_OVER_PRIOR})")
    res = {"phase": "train:nel_shared", "seconds": seconds, "steps": result.final_step,
           "nel_micro_f": f, "nel_floor": floor, "prior_only_dev_nel_micro_f": baseline,
           "linker_loss_first_last": [result.step_head_losses[0]["entity_linker"],
                                      result.step_head_losses[-1]["entity_linker"]],
           "launches": launches}
    emit(res)
    return res


def card_vs_cpu(model_dir: Path, answers) -> dict:
    """How far the served answers equal the same model directory's
    annotations on the CPU over the same texts: per token field (tags, heads,
    deps, pos, morphs, lemmas, sent_starts) the share of tokens that agree;
    the entity sets' and each span key's sets' F; the share of docs whose
    top cat agrees, and ``cats_max_abs_diff``, the largest |p_card - p_cpu|
    of any cat (reported, not a share)."""
    from spacy_ray_tpu_torch import Pipeline

    cpu = Pipeline.from_disk(model_dir, device="cpu")
    got, want = [], []
    for _, ts, body in answers:
        docs = [cpu.tokenizer(t) for t in ts]
        cpu.predict_docs(docs)
        got.extend(body["docs"])
        want.extend(docs)
    return agreement(cpu, got, want)


def agreement(cpu, got, want) -> dict:
    """``card_vs_cpu``'s measures of the served docs ``got`` (JSON) against
    the CPU pipeline ``cpu``'s docs ``want``, one for one."""
    for d, served in zip(got, want):
        if served.words != d["tokens"]:
            fail(f"card and CPU tokenized differently: {d['tokens']} vs {served.words}")
    out = {}
    for key in ("tags", "heads", "deps", "pos", "morphs", "lemmas", "sent_starts"):
        pairs = [(a, b) for s, d in zip(got, want) if getattr(d, key) is not None
                 for a, b in zip(s.get(key, []), getattr(d, key))]
        if pairs:
            out[key] = sum(a == b for a, b in pairs) / len(pairs)
    if "ner" in cpu.pipe_names:
        served_ents = {(i, e[0], e[1], e[2]) for i, s in enumerate(got) for e in s.get("ents", [])}
        cpu_ents = {(i, e.start, e.end, e.label) for i, d in enumerate(want) for e in d.ents}
        out["ents_f"] = set_f(served_ents, cpu_ents)
    if "entity_linker" in cpu.pipe_names:  # the links: a served entity's kb_id is its 4th field
        served_links = {(i, *e[:3], e[3] if len(e) > 3 else "")
                        for i, s in enumerate(got) for e in s.get("ents", [])}
        cpu_links = {(i, e.start, e.end, e.label, e.kb_id)
                     for i, d in enumerate(want) for e in d.ents}
        out["kb_ids_f"] = set_f(served_links, cpu_links)
    for key in sorted({k for d in want for k in d.spans}):
        served = {(i, *sp) for i, s in enumerate(got) for sp in s.get("spans", {}).get(key, [])}
        on_cpu = {(i, sp.start, sp.end, sp.label) for i, d in enumerate(want)
                  for sp in d.spans.get(key, [])}
        out[f"spans_{key}_f"] = set_f(served, on_cpu)
    cats = [(s.get("cats", {}), d.cats) for s, d in zip(got, want) if d.cats]
    if cats:
        out["cats_top"] = sum(max(a, key=a.get) == max(b, key=b.get) for a, b in cats) / len(cats)
        out["cats_max_abs_diff"] = max(abs(a[k] - b[k]) for a, b in cats for k in b)
    return out


def check_served_doc(nlp, d: dict, phase: str) -> int:
    """Fails unless the served doc ``d`` carries each head's annotation with
    the model's labels; returns its span count."""
    n = len(d["tokens"])
    comps = nlp.components
    for name, key in (("tagger", "tags"), ("morphologizer", "pos"),
                      ("morphologizer", "morphs"), ("senter", "sent_starts"),
                      ("trainable_lemmatizer", "lemmas"), ("attribute_ruler", "pos"),
                      ("lemmatizer", "lemmas")):
        if name in comps and len(d.get(key) or []) != n:
            fail(f"{phase}: doc without {key}: {d}")
    if "tagger" in comps and not set(d["tags"]) <= set(comps["tagger"].labels):
        fail(f"{phase}: unknown tags in {d}")
    linker = comps.get("entity_linker")
    if linker is not None and linker.threshold == 0:  # every alias of the KB gets a link
        for e in d.get("ents", []):
            cands = {c.entity for c in linker.kb.candidates(
                " ".join(d["tokens"][e[0]:e[1]]))[:linker.n_candidates]}
            if cands and not (len(e) > 3 and e[3] in cands):
                fail(f"{phase}: entity {e} is an alias of the KB but has no candidate's kb_id")
    spans = 0
    if "spancat" in comps:
        labels = set(comps["spancat"].labels)
        sc = d.get("spans", {}).get("sc")
        if sc is None or not all(0 <= a < b <= n and lab in labels for a, b, lab in sc):
            fail(f"{phase}: doc without spans['sc'] or with a span outside it: {d}")
        spans = len(sc)
    for name in ("textcat", "textcat_multilabel"):
        if name in comps and set(d.get("cats", {})) != set(comps[name].labels):
            fail(f"{phase}: doc without every cat: {d}")
    return spans


def phase_slice_cnn(torch, model_dir: Path, dev_path: Path, phase: str = "slice:cnn"):
    """``model_dir`` (the best-model of ``train:cnn``, or of the phase
    ``phase`` names; for slice:md_jax the JAX-written md directory) served
    through the ``serve`` entry point at ``--precision auto`` with
    slice:auto's request pattern over dev texts; K1 fwd must launch, the
    label must say f32 (a CNN has no transformer trunk to overlay), every
    doc must carry each head's annotation (tags, pos and morphs, sentence
    starts, lemmas, ``spans["sc"]`` inside the doc, every cat; the rule
    components' pos and lemmas), and the card's answers must agree with the
    same model's on the CPU on >= 0.99 (tokens, span and entity sets' F,
    docs' top cat). Then one forward at the top bucket (B 8, T 128) is
    timed."""
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.doc import Example
    from spacy_ray_tpu_torch.training.corpus import Corpus

    t0 = time.perf_counter()
    server = build_server([str(model_dir), "--port", "0", "--max-batch", "8",
                           "--max-doc-len", "128", "--precision", "auto"])
    engine = server.engine
    nlp = engine.nlp
    try:
        _, port = server.start()
        engine.start()
        setup_s = time.perf_counter() - t0
        label = engine.overlay.label
        if engine.overlay.resolved != "f32" or "no transformer trunk" not in label:
            fail(f"{phase}: precision auto resolved to {label!r}, expected f32 "
                 "with the overlay refused")
        texts = [" ".join(eg.reference.words) for eg in Corpus(dev_path)()
                 if len(eg.reference.words) <= 100][:24]
        latencies, answers = [], []
        lock = threading.Lock()

        def client(batch):
            for ts in batch:
                t = time.perf_counter()
                status, body = post(port, ts)
                with lock:
                    latencies.append(time.perf_counter() - t)
                    answers.append((status, ts, body))

        sequential = [[t] for t in texts[:4]]
        concurrent = [[[texts[4 + 5 * c + i]] if i % 2 else texts[4 + 5 * c + i: 6 + 5 * c + i]
                       for i in range(3)] for c in range(4)]
        _cuda.reset_launch_counts()
        client(sequential)
        threads = [threading.Thread(target=client, args=(c,)) for c in concurrent]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
        if launches["hash_embed_gather_sum"] == 0:
            fail(f"{phase}: K1 fwd never launched on the serving path")
        n_spans = 0
        for status, ts, body in answers:
            if status != 200 or len(body["docs"]) != len(ts):
                fail(f"{phase}: /v1/parse answered {status}: {body}")
            for d in body["docs"]:
                n_spans += check_served_doc(nlp, d, phase)
        if "spancat" in nlp.components and n_spans == 0:
            fail(f"{phase}: no response carried a span")
        agree = card_vs_cpu(model_dir, answers)
        low = {k: v for k, v in agree.items() if k != "cats_max_abs_diff" and v < 0.99}
        if low:
            fail(f"{phase}: card and CPU answers agree only {agree} (< 0.99)")

        docs = [nlp.tokenizer(t) for t in texts[:8]]
        top = nlp.collate([Example.from_gold(d) for d in docs], pad_batch_to=8,
                          pad_len_to=128)["tokens"]

        def forward():
            nlp.forward(top)

        with torch.inference_mode():
            ops = device_ops(torch, forward)
            forward_row = {"ms": time_ms(torch, forward, reps=10),
                           "enqueue_ms": enqueue_ms(torch, forward),
                           "device_ops": sum(v[0] for v in ops.values())}
        server.request_shutdown()
        if server.wait() != 0:
            fail(f"{phase}: serve drain failed")
        result = {
            "phase": phase, "precision_label": label, "requests": len(answers),
            "spans": n_spans,
            "batches_seen": sorted({(b["batch"]["B"], b["batch"]["T"], b["batch"]["occupancy"])
                                    for _, _, b in answers}),
            "launches": launches, "latency_p50_ms": percentile(latencies, 0.50) * 1e3,
            "latency_p99_ms": percentile(latencies, 0.99) * 1e3, "setup_s": setup_s,
            "warmed_buckets": len(engine.warmed), "card_vs_cpu_agreement": agree,
            "forward_B8_T128": forward_row,
            "vectors": None if nlp.vectors is None else list(nlp.vectors.table.shape),
        }
        emit(result)
        return result
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine, nlp
        torch.cuda.empty_cache()


def phase_slice_nel_jax(torch):
    """``tests/data/jax_nel/`` (written by the JAX package,
    ``bin/make_jax_nel_fixture.py``) served through the ``serve`` entry point:
    its ``answers.json`` texts as four one-text requests, then two
    concurrent requests of the rest; K1 fwd must launch and every doc's
    entities and kb_ids must equal the JAX package's own answers."""
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.ops import _cuda

    path = ROOT / "tests" / "data" / "jax_nel"
    answers = json.loads((path / "answers.json").read_text(encoding="utf8"))
    want = dict(zip(answers["texts"], answers["ents"]))
    t0 = time.perf_counter()
    server = build_server([str(path), "--port", "0", "--max-batch", "8",
                           "--max-doc-len", "128", "--precision", "auto"])
    engine = server.engine
    try:
        _, port = server.start()
        engine.start()
        setup_s = time.perf_counter() - t0
        texts = answers["texts"]
        latencies, got = [], []
        lock = threading.Lock()

        def client(batch):
            for ts in batch:
                t = time.perf_counter()
                status, body = post(port, ts)
                with lock:
                    latencies.append(time.perf_counter() - t)
                    got.append((status, ts, body))

        _cuda.reset_launch_counts()
        client([[t] for t in texts[:4]])
        threads = [threading.Thread(target=client, args=([part],))
                   for part in (texts[4:8], texts[8:])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
        if launches["hash_embed_gather_sum"] == 0:
            fail("slice:nel_jax: K1 fwd never launched on the serving path")
        n_links = 0
        for status, ts, body in got:
            if status != 200 or len(body["docs"]) != len(ts):
                fail(f"slice:nel_jax: /v1/parse answered {status}: {body}")
            for t, d in zip(ts, body["docs"]):
                ents = [e + [""] * (4 - len(e)) for e in d.get("ents", [])]
                if ents != want[t]:
                    fail(f"slice:nel_jax: served {ents}, the JAX package answered {want[t]}")
                n_links += sum(bool(e[3]) for e in ents)
        server.request_shutdown()
        if server.wait() != 0:
            fail("slice:nel_jax: serve drain failed")
        result = {"phase": "slice:nel_jax", "requests": len(got), "docs": len(texts),
                  "links_equal_to_jax": n_links, "launches": launches, "setup_s": setup_s,
                  "latency_p50_ms": percentile(latencies, 0.50) * 1e3,
                  "latency_p99_ms": percentile(latencies, 0.99) * 1e3}
        emit(result)
        return result
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine
        torch.cuda.empty_cache()


# ------------------------------------------------- a trunk started from weights

PRETRAIN_STEPS = 200         # pretrain:chars ([pretraining] max_steps cut from 1000)
PRETRAIN_VECTOR_STEPS = 60   # pretrain:vectors
PRETRAIN_BATCH = 64          # [pretraining] batch_size, in docs
CHAR_HIDDEN = 300            # spaCy's PretrainCharacters hidden width
#: train:cnn_pretrained's dev floor: train:cnn holds no tag_acc floor in
#: DEV_FLOORS, so md's tagger floor on the same corpus
CNN_PRETRAINED_FLOORS = {"tag_acc": 0.9}
TRF_INIT_STEPS = 20          # train:trf_init: trf.cfg's [training], max_steps cut
#: spaCy's English orth variants (``spacy/lang/en``): the single group of
#: dashes, and the quote pairs as spaCy writes them
EN_ORTH_VARIANTS = {
    "single": [{"tags": [":"], "variants": ["-", "—", "–", "--", "---", "——"]}],
    "paired": [{"tags": ["``", "''"], "variants": [["'", "'"], ["‘", "’"]]},
               {"tags": ["``", "''"], "variants": [['"', '"'], ["“", "”"]]}],
}
#: what ``--code`` imports in train:cnn_pretrained
USER_CODE = '''"""A user's file for ``--code``: a ``[training.before_update]`` callback
that records each call's (step, epoch) and, at step 0, a digest of the
trunk's parameters; and a ``[training.logger]`` that keeps each
evaluation's scores beside the console logger's table."""

import hashlib
import json
from pathlib import Path

import numpy as np

from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.registry import registry


def digest(flat):
    """SHA-256 over the sorted keys and each array's float32 bytes."""
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode("utf8"))
        h.update(np.ascontiguousarray(flat[k], dtype=np.float32).tobytes())
    return h.hexdigest()


@registry.callbacks("chip_smoke_user.record_steps.v1")
def record_steps(path: str, component: str = "tok2vec"):
    record = {"calls": [], "step0_digest": None}

    def before_update(nlp, info):
        if info["step"] == 0:
            trunk = param_paths(nlp.model[component])
            record["step0_digest"] = digest({k: v.cpu().numpy() for k, v in trunk.items()})
        record["calls"].append([info["step"], info["epoch"]])
        Path(path).write_text(json.dumps(record))

    return before_update


@registry.loggers("chip_smoke_user.scores.v1")
def scores_logger(path: str):
    console = registry.get("loggers", "spacy_ray_tpu.ConsoleLogger.v1")()

    def setup(nlp, stdout, stderr):
        log_step, finalize = console(nlp, stdout, stderr)
        rows = []

        def step(info):
            log_step(info)
            if info is not None:
                rows.append({"step": info["step"], "losses": info["losses"],
                             "scores": {k: v for k, v in info["other_scores"].items()
                                        if isinstance(v, (int, float))}})
                Path(path).write_text(json.dumps(rows))

        return step, finalize

    return setup
'''


def write_raw_text(train_path) -> Path:
    """The pretraining corpus: udgen's training docs joined into text, one
    ``{"text": ...}`` line each (``spacy.JsonlCorpus.v1``'s raw lines)."""
    from spacy_ray_tpu_torch.training.corpus import read_jsonl_docs

    work = WORK / "pretrain"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = work / "raw.jsonl"
    with open(out, "w", encoding="utf8") as f:
        for doc in read_jsonl_docs(train_path):
            f.write(json.dumps({"text": doc.text}) + "\n")
    return out


def pretrain_config(paths, raw: Path, objective: str, steps: int, vectors=None):
    """configs/cnn.cfg as written (its trunk: HashEmbedCNN.v2, width 96,
    depth 4, embed_size 2000) with a ``[pretraining]`` block over ``raw``:
    the characters objective (4 characters, hidden 300) or the vectors one
    (cosine, over ``vectors`` as ``[initialize] vectors``), batch_size 64,
    Adam.v1 at 0.001, ``steps`` steps."""
    cfg = cnn_config("cnn", paths)
    cfg["corpora"]["pretrain"] = {"@readers": "spacy.JsonlCorpus.v1", "path": str(raw)}
    obj = ({"type": "characters", "n_characters": 4, "hidden_size": CHAR_HIDDEN}
           if objective == "characters" else {"type": "vectors", "loss": "cosine"})
    cfg["pretraining"] = {"component": "tok2vec", "corpus": "corpora.pretrain",
                          "max_steps": steps, "batch_size": PRETRAIN_BATCH, "seed": 0,
                          "objective": obj,
                          "optimizer": {"@optimizers": "Adam.v1", "learn_rate": 0.001}}
    if vectors is not None:
        cfg["initialize"] = {"vectors": str(vectors)}
    return cfg


def pretrain_leaf_shapes(cfg):
    """The shapes of the leaves a pretraining step hands K5: the trunk's and
    the objective head's (built on the CPU)."""
    from spacy_ray_tpu_torch.training.pretrain import Pretraining

    return [tuple(p.shape) for p in Pretraining(cfg, device="cpu").params().values()]


def pretrain_grad_check(torch, cfg):
    """One pretraining batch's gradients of every leaf, trunk and head,
    with the kernels against the plain versions (weights fresh from the
    seed, no dropout: {leaf: max |g - g_plain| / max |g_plain|}), and the
    control of ``grad_check``: what one dropped table row would read."""
    import contextlib
    import itertools

    from spacy_ray_tpu_torch.models.core import Context
    from spacy_ray_tpu_torch.training.corpus import use_raw_text_tokenizer
    from spacy_ray_tpu_torch.training.pretrain import Pretraining

    run = Pretraining(cfg, device="cuda")
    with use_raw_text_tokenizer(run.nlp.tokenizer):
        egs = list(itertools.islice(run.corpus(), PRETRAIN_BATCH))
    tokens, targets, _ = run.batch(egs)
    params = run.params()
    for p in params.values():
        p.requires_grad_(True)
    grads = []
    for plain in (False, True):
        for p in params.values():
            p.grad = None
        with plain_kernels() if plain else contextlib.nullcontext():
            run.loss_fn(tokens, targets, Context(train=True))[0].backward()
        grads.append({k: p.grad.detach().clone() for k, p in params.items()})
    rel = {k: (grads[0][k] - grads[1][k]).abs().max().item()
           / max(grads[1][k].abs().max().item(), 1e-30) for k in params}
    control = min(table_row_share(g) for k, g in grads[1].items() if k.endswith("/E"))
    return rel, control, list(tokens.mask.shape)


def phase_pretrain(torch, name: str, cfg, steps: int):
    """``python -m spacy_ray_tpu_torch pretrain`` on ``cfg`` (the command's
    ``main``, in this process, so that the launch counters and the peak
    memory can be read; counters zeroed just before, read just after):
    K1 fwd, K1 bwd and K5 must launch, the loss of the last 5 steps must be
    <= 2/3 of the first 5 steps' mean (and ``char_acc`` rise, for the
    characters), and ``model-last.npz`` must hold the trunk's own key set
    and shapes. Reports the step ms (events and host, from the run's
    ``log.jsonl``), words/s, the peak memory; for the characters, every
    leaf's gradient with the kernels against the plain versions."""
    import numpy as np

    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.__main__ import main as cli
    from spacy_ray_tpu_torch.models.core import param_paths
    from spacy_ray_tpu_torch.ops import _cuda

    phase = f"pretrain:{name}"
    work = WORK / f"pretrain_{name}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg.to_disk(work / "pretrain.cfg")
    out = work / "out"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()) as said:
        rc = cli(["pretrain", str(work / "pretrain.cfg"), str(out)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    printed = said.getvalue().strip().splitlines()
    if rc != 0 or not printed or not printed[-1].startswith("Pretraining done."):
        fail(f"{phase}: pretrain exited {rc}: {printed[-3:]}")
    missing = [k for k in ("hash_embed_gather_sum", "hash_embed_table_grad", "fused_update")
               if launches[k] == 0]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    log = [json.loads(line) for line in (out / "log.jsonl").read_text().splitlines()]
    if [r["step"] for r in log] != list(range(1, steps + 1)):
        fail(f"{phase}: log.jsonl holds steps {[r['step'] for r in log][:3]}..., "
             f"not 1..{steps}")
    losses = [r["loss"] for r in log]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{phase}: a loss is not finite")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last <= 2 / 3 * first:
        fail(f"{phase}: the loss fell from {first} to only {last} (> 2/3)")
    res = {"phase": phase, "config": "configs/cnn.cfg's trunk as written + [pretraining] "
           f"({cfg['pretraining']['objective']}, batch_size {PRETRAIN_BATCH}, Adam.v1 0.001, "
           f"{steps} steps) over udgen's 2000 training docs as raw text",
           "seconds": seconds, "printed": printed[-1], "steps": len(log),
           "epochs": log[-1]["epoch"], "loss_first5_mean": first, "loss_last5_mean": last,
           "loss_first": losses[0], "loss_last": losses[-1], "launches": launches,
           "peak_memory_gb": peak_gb}
    if "char_acc" in log[0]:
        acc = [r["char_acc"] for r in log]
        a_first, a_last = statistics.mean(acc[:5]), statistics.mean(acc[-5:])
        if not a_last > a_first:
            fail(f"{phase}: char_acc did not rise ({a_first} -> {a_last})")
        res.update(char_acc_first5_mean=a_first, char_acc_last5_mean=a_last)
    with np.load(out / "model-last.npz") as saved:
        got = {k: saved[k].shape for k in saved.files}
    trunk = Pipeline.from_config(cfg.interpolate(), device="cpu").components["tok2vec"]
    want = {k: tuple(v.shape) for k, v in param_paths(trunk.build_model()).items()}
    if got != want:
        fail(f"{phase}: model-last.npz keys/shapes differ from the trunk's: "
             f"{sorted(set(got) ^ set(want))[:5]}")
    event_ms = [r["step_ms_events"] for r in log]
    words = sum(r["words"] for r in log)
    res.update(
        model_last_keys=len(got), step_ms_median_events=statistics.median(event_ms),
        step_ms_median_host=statistics.median(r["step_s_host"] * 1e3 for r in log),
        step_ms_quartiles_events=statistics.quantiles(event_ms, n=4),
        words=words, words_per_s_events=words / (sum(event_ms) / 1e3),
        words_per_s_wall=words / seconds)
    if name == "chars":
        rel, control, shape = pretrain_grad_check(torch, cfg)
        worst = max(rel, key=rel.get)
        if not rel[worst] <= TOL_GRAD_CNN:
            fail(f"{phase}: gradient of {worst} kernels vs plain {rel[worst]} > {TOL_GRAD_CNN}")
        if not control > TOL_GRAD_CNN:
            fail(f"{phase}: a dropped table row would read {control}, not above {TOL_GRAD_CNN}")
        res.update(grad_batch_B_T=shape, grad_leaves=len(rel), grad_max_rel_err=rel[worst],
                   grad_worst_leaf=worst, grad_tol=TOL_GRAD_CNN, grad_control_row_drop=control)
    else:
        res["targets"] = vector_target_mask(torch, cfg)
    emit(res)
    return res, out / "model-last.npz"


def vector_target_mask(torch, cfg) -> dict:
    """The vectors objective's first batch: its targets only on real tokens
    that have a vector (a row of the table, the lower-case fallback
    included), and equal to those rows."""
    import itertools

    from spacy_ray_tpu_torch.training.corpus import use_raw_text_tokenizer
    from spacy_ray_tpu_torch.training.pretrain import Pretraining

    run = Pretraining(cfg, device="cuda")
    with use_raw_text_tokenizer(run.nlp.tokenizer):
        egs = list(itertools.islice(run.corpus(), PRETRAIN_BATCH))
    tokens, targets, _ = run.batch(egs)
    mask, has = tokens.mask, targets["has_vec"]
    rows = tokens.vector_rows
    if bool((has & ~mask).any()) or not torch.equal(has, mask & (rows >= 0)):
        fail("pretrain:vectors: targets outside the tokens that have a vector")
    table = torch.from_numpy(run.nlp.vectors.table).to(rows.device)
    if not torch.equal(targets["vectors"][has], table[rows[has]]):
        fail("pretrain:vectors: a target is not its token's vector")
    if bool(targets["vectors"][~has].any()):
        fail("pretrain:vectors: a masked target is not zero")
    return {"real_tokens": int(mask.sum()), "with_a_vector": int(has.sum()),
            "without": int((mask & ~has).sum())}


def cnn_pretrained_config(paths, work: Path):
    """configs/cnn.cfg as written, with what train:cnn_pretrained adds: an
    ``spacy.orth_variants.v1`` augmenter on the train corpus (level 0.1,
    lower 0.5, ``EN_ORTH_VARIANTS``), the ``--code`` file's callback as
    ``[training.before_update]`` and its logger as ``[training.logger]``;
    ``max_steps`` and ``eval_frequency`` cut."""
    cfg = cnn_config("cnn", paths)
    cfg["corpora"]["train"]["augmenter"] = {
        "@augmenters": "spacy.orth_variants.v1", "level": 0.1, "lower": 0.5,
        "orth_variants": EN_ORTH_VARIANTS}
    cfg["training"].update(max_steps=CNN_STEPS, eval_frequency=CNN_EVAL)
    cfg["training"]["before_update"] = {"@callbacks": "chip_smoke_user.record_steps.v1",
                                        "path": str(work / "steps.json")}
    cfg["training"]["logger"] = {"@loggers": "chip_smoke_user.scores.v1",
                                 "path": str(work / "scores.json")}
    return cfg


def phase_train_cnn_pretrained(torch, paths, pretrained: Path):
    """``python -m spacy_ray_tpu_torch train`` (its ``main``, in this
    process; counters zeroed just before, read just after) on
    ``cnn_pretrained_config`` with ``--code`` (the file ``USER_CODE``) and
    ``--initialize.init_tok2vec`` at pretrain:chars' ``model-last.npz``:
    the trunk at step 0 bit-equal to the file (the callback's digest),
    ``before_update`` for every step in order, the tagger's loss falling to
    <= 2/3 and dev ``tag_acc`` holding ``CNN_PRETRAINED_FLOORS`` at the last
    evaluation; then, over the augmented corpus, a microbatch's collate ms
    uncached, cached and as an augmented epoch yields it (its copies fresh,
    its originals cached)."""
    import importlib

    import numpy as np

    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.__main__ import main as cli
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.doc import Example
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length

    phase = "train:cnn_pretrained"
    work = WORK / "cnn_pretrained"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    code = work / "user_code.py"
    code.write_text(USER_CODE)
    cfg = cnn_pretrained_config(paths, work)
    cfg.to_disk(work / "config.cfg")
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()) as said:
        rc = cli(["train", str(work / "config.cfg"), "--output", str(work / "out"),
                  "--code", str(code), "--initialize.init_tok2vec", str(pretrained)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    printed = said.getvalue().strip().splitlines()
    if rc != 0 or not any(line.startswith(f"Done. steps={CNN_STEPS}") for line in printed):
        fail(f"{phase}: train exited {rc}: {printed[-3:]}")
    missing = [k for k in ("hash_embed_gather_sum", "hash_embed_table_grad", "fused_update")
               if launches[k] == 0]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    user = importlib.import_module("_user_code_user_code")
    steps = json.loads((work / "steps.json").read_text())
    with np.load(pretrained) as saved:
        file_digest = user.digest({k: saved[k] for k in saved.files})
    if steps["step0_digest"] != file_digest:
        fail(f"{phase}: the trunk at step 0 is not the pretrained file's")
    if [s for s, _ in steps["calls"]] != list(range(CNN_STEPS)):
        fail(f"{phase}: before_update calls {steps['calls'][:4]}..., not steps "
             f"0..{CNN_STEPS - 1} in order")
    rows = json.loads((work / "scores.json").read_text())
    losses = [r["losses"]["tagger"] for r in rows]
    if not losses[-1] <= 2 / 3 * losses[0]:
        fail(f"{phase}: the tagger's loss per evaluation {losses} did not fall to <= 2/3")
    last = rows[-1]
    low = {k: last["scores"].get(k) for k, v in CNN_PRETRAINED_FLOORS.items()
           if not (last["scores"].get(k) or 0) >= v}
    if last["step"] != CNN_STEPS or low:
        fail(f"{phase}: dev scores at step {last['step']} below {CNN_PRETRAINED_FLOORS}: {low}")

    # the collate over the augmented corpus: an epoch collated once, then a
    # microbatch of the next epoch as the loop collates it, the same again
    # (every Example now cached), and fresh copies of it (none cached)
    cfg_i = cfg.interpolate()
    nlp = Pipeline.from_disk(work / "out" / "best-model", device="cuda")
    corpus = registry.resolve(cfg_i["corpora"]["train"])
    batcher = registry.resolve(cfg_i["training"]["batcher"])
    for b in batcher(corpus()):
        nlp.collate(b, with_targets=True)
    batch = next(iter(batcher(corpus())))
    copies = sum(not any(eg is c for c in corpus._examples) for eg in batch)
    if copies == 0 or any(getattr(eg, "_feat_cache", None) is not None
                          for eg in batch if not any(eg is c for c in corpus._examples)):
        fail(f"{phase}: {copies} augmented copies in the microbatch, or a copy came cached")
    B, T = bucket_batch_size(len(batch)), bucket_length(max(len(eg) for eg in batch))
    collate_ms = {}
    for label, egs in (("augmented_epoch", batch), ("cached", batch),
                       ("uncached", [Example.from_gold(eg.reference) for eg in batch])):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nlp.collate(egs, with_targets=True, pad_batch_to=B, pad_len_to=T)
        torch.cuda.synchronize()
        collate_ms[label] = (time.perf_counter() - t) * 1e3
    del nlp
    shutil.rmtree(work, ignore_errors=True)
    res = {"phase": phase, "config": "configs/cnn.cfg as written + spacy.orth_variants.v1 "
           "(level 0.1, lower 0.5, spaCy's English dash and quote groups) + --code "
           "(before_update, logger) + --initialize.init_tok2vec pretrain:chars' "
           f"model-last.npz; max_steps {CNN_STEPS}, eval_frequency {CNN_EVAL} (cut)",
           "seconds": seconds, "printed": [line for line in printed
                                           if line.startswith("Done.")],
           "step0_trunk_equals_pretrained_file": True,
           "before_update_calls": len(steps["calls"]), "epochs": steps["calls"][-1][1],
           "tagger_loss_per_evaluation": losses,
           "dev_scores": [(r["step"], {k: r["scores"].get(k) for k in ("tag_acc", "pos_acc")
                                       if k in r["scores"]}) for r in rows],
           "dev_floors": CNN_PRETRAINED_FLOORS, "launches": launches,
           "collate_microbatch_B_T": [B, T], "augmented_copies_in_microbatch": copies,
           "collate_ms_with_copy": collate_ms}
    emit(res)
    return res


def write_roberta_checkpoint(path: Path, *, layers: int, width: int, ffn: int,
                             pos_rows: int, seed: int = 0) -> dict:
    """A checkpoint in RoBERTa-base's layout, made from ``seed`` with the
    port's ``write_safetensors`` (no real checkpoint is in the repository):
    ``roberta.encoder.layer.N.*`` for ``layers`` layers of ``width`` (FFN
    ``ffn``), ``[out, in]`` weights and biases N(0, 0.02), layer norms 1 +
    N(0, 0.02) and N(0, 0.02), and the ``pos_rows``-row position table
    (RoBERTa's two padding rows first); F32, ~340 MB at RoBERTa-base's
    sizes (12 layers, 768 wide, FFN 3072, 514 rows). Returns the tensors."""
    import numpy as np

    from spacy_ray_tpu_torch.models.pretrained import write_safetensors

    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    hf = {}
    for i in range(layers):
        pre = f"roberta.encoder.layer.{i}."
        for part in ("query", "key", "value"):
            hf[f"{pre}attention.self.{part}.weight"] = w(width, width)
            hf[f"{pre}attention.self.{part}.bias"] = w(width)
        for block, n_in in (("attention.output", width), ("output", ffn)):
            hf[f"{pre}{block}.dense.weight"] = w(width, n_in)
            hf[f"{pre}{block}.dense.bias"] = w(width)
            hf[f"{pre}{block}.LayerNorm.weight"] = 1 + w(width)
            hf[f"{pre}{block}.LayerNorm.bias"] = w(width)
        hf[f"{pre}intermediate.dense.weight"] = w(ffn, width)
        hf[f"{pre}intermediate.dense.bias"] = w(ffn)
    hf["roberta.embeddings.position_embeddings.weight"] = w(pos_rows, width)
    write_safetensors(path, hf)
    return hf


#: the trunk's encoder leaves at train:trf_init's first before_update call
TRUNK_AT_STEP_0 = {}
TRUNK_SNAPSHOT = "chip_smoke.trunk_snapshot.v1"


def register_trunk_snapshot(registry) -> None:
    """Register the callback train:trf_init names: at step 0 it copies the
    transformer's parameters to the host into ``TRUNK_AT_STEP_0``."""
    def make():
        def before_update(nlp, info):
            if info["step"] == 0:
                from spacy_ray_tpu_torch.models.core import param_paths

                TRUNK_AT_STEP_0.update({k: v.cpu().numpy().copy() for k, v in
                                        param_paths(nlp.model["transformer"]).items()})
        return before_update

    registry.callbacks(TRUNK_SNAPSHOT)(make)


def phase_train_trf_init(torch):
    """``train()`` of trf.cfg's trunk + tagger (``trf_tagger_config``) with
    ``init_weights`` at a checkpoint in RoBERTa-base's layout from seed 0
    at the trunk's sizes (``write_roberta_checkpoint``, in a temporary
    directory deleted after), on train:trf's synthetic tagged corpus (its
    microbatch B 64, T 128), ``max_steps`` 20, the trunk at depth
    ``TRF_CUT_DEPTH``: its 12 x depth encoder leaves and ``pos`` (its 512 rows; the file's
    514 less RoBERTa's two padding rows) at step 0 on the card bit-equal to
    ``hf_encoder_to_native`` of the file, the load's one-line report, the
    loss falling, and K1 fwd/bwd, K2, K3 and K5 launched (counters zeroed
    just before, read just after)."""
    import tempfile

    import numpy as np

    from spacy_ray_tpu_torch.models.pretrained import hf_encoder_to_native
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.loop import train
    from spacy_ray_tpu_torch.util import write_synth_jsonl

    phase = "train:trf_init"
    register_trunk_snapshot(registry)
    TRUNK_AT_STEP_0.clear()
    cfg = trf_tagger_config()
    model = cfg["components"]["transformer"]["model"]
    model["depth"] = TRF_CUT_DEPTH
    depth, width, max_len = model["depth"], model["width"], model["max_len"]
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        ckpt = Path(tmp) / "roberta-base-layout.safetensors"
        t = time.perf_counter()
        hf = write_roberta_checkpoint(ckpt, layers=depth, width=width,
                                      ffn=width * model["ffn_mult"], pos_rows=max_len + 2)
        write_s, file_mb = time.perf_counter() - t, ckpt.stat().st_size / 1e6
        want = hf_encoder_to_native(hf, native_pos_rows=max_len)
        del hf
        for split, n, seed in (("train", 2000, 0), ("dev", 200, 1)):
            write_synth_jsonl(Path(tmp) / f"{split}.jsonl", n, seed=seed, min_len=8,
                              max_len=120)
        cfg["paths"] = {"train": str(Path(tmp) / "train.jsonl"),
                        "dev": str(Path(tmp) / "dev.jsonl")}
        model["init_weights"] = str(ckpt)
        cfg["training"].update(max_steps=TRF_INIT_STEPS, eval_frequency=TRF_INIT_STEPS,
                               before_update={"@callbacks": TRUNK_SNAPSHOT})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()) as said:
            nlp, result = train(cfg, None, device="cuda", stdout_log=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _cuda.launch_counts()
    report = [line for line in said.getvalue().splitlines() if line.startswith("[transformer]")]
    if len(report) != 1:
        fail(f"{phase}: the load printed {report}")
    encoder = [k for k in want if k.startswith("layer_")]
    if len(encoder) != 12 * depth or want["pos"].shape != (max_len, width):
        fail(f"{phase}: the remap gave {len(encoder)} encoder leaves, pos {want['pos'].shape}")
    bad = [k for k, v in want.items() if not np.array_equal(TRUNK_AT_STEP_0.get(k), v)]
    if bad:
        fail(f"{phase}: trunk leaves at step 0 differ from the remapped file: {bad[:5]}")
    need = ["hash_embed_gather_sum", "hash_embed_table_grad", "flash_attention_fwd",
            "flash_attention_bwd", "fused_update"]
    missing = [k for k in need if launches[k] == 0]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    losses = result.step_losses
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if len(losses) != TRF_INIT_STEPS or not all(math.isfinite(x) for x in losses) \
            or not last < first:
        fail(f"{phase}: the loss did not fall ({first} -> {last}, {len(losses)} steps)")
    event_ms = [a.elapsed_time(b) for a, b in result.step_events]
    res = {"phase": phase, "config": "configs/trf.cfg's transformer + tagger and [training] "
           f"(max_steps {TRF_INIT_STEPS}, cut), init_weights = a RoBERTa-base-layout "
           f".safetensors from seed 0 ({depth} layers, cut from 12; 768 wide, [out, in], "
           "514 position rows, F32)",
           "checkpoint_mb": file_mb, "checkpoint_write_s": write_s, "load_report": report[0],
           "encoder_leaves_bit_equal": len(encoder), "pos_rows_bit_equal": max_len,
           "seconds": seconds, "steps": result.final_step,
           "group_shapes_B_T": sorted(set(result.step_shapes)),
           "loss_first5_mean": first, "loss_last5_mean": last,
           "dev_tag_acc": [(h["step"], h["other_scores"].get("tag_acc")) for h in result.history],
           "step_ms_median_events": statistics.median(event_ms),
           "step_ms_median_host": statistics.median(x * 1e3 for x in result.step_host_seconds),
           "words_per_s": result.wps, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    TRUNK_AT_STEP_0.clear()
    del nlp, result
    torch.cuda.empty_cache()
    emit(res)
    return res


# ------------------------------------------------------------ MoE trunks

MOE_EXPERTS = 8            # bench.py's trf_moe: trf.cfg's trunk with 8 experts
MOE_STEPS, MOE_EVAL = 30, 15   # train:moe: max_steps cut; two evaluations, two generations
MOE_BATCH_WORDS = 330      # batch_by_words size: microbatches of B 16 (T 64 or 128) on udgen
MOE_SERVE = ["--max-batch", "4", "--max-doc-len", "64"]
MOE_RPS, MOE_LOAD_S = 20.0, 4.0  # slice:moe's fixed offered load, open loop
MOE_TEXTS = 16             # dev texts of <= 64 words the MoE phases serve
SWAP_CLIENTS, SWAP_TEXTS = 4, 2  # serve:swap's concurrent clients, texts a request
TOL_MOE_AUX = 1e-5         # loss_aux against the recompute, relative: the same ops
TOL_MOE_JAX_TRUNK = 1e-4   # f32 trunk on the card against JAX's f32 on the CPU, max |diff|
FLOOR_MOE_F32 = 0.99       # f32 served answers against the CPU's, per token field
FLOOR_MOE_BF16 = 0.95      # bf16 served answers against the CPU's f32 (kernels vs plain's floor)


def moe_cli_args(udgen, out: Path):
    """``python -m spacy_ray_tpu_torch train configs/trf.cfg`` with 8
    experts on the udgen corpus, its [training] block cut in max_steps,
    eval_frequency and the batcher's size (microbatches of B 16)."""
    return ["train", str(ROOT / "configs" / "trf.cfg"), "--output", str(out),
            "--paths.train", str(udgen[0]), "--paths.dev", str(udgen[1]),
            "--components.transformer.model.n_experts", str(MOE_EXPERTS),
            "--training.max_steps", str(MOE_STEPS),
            "--training.eval_frequency", str(MOE_EVAL),
            "--training.batcher.size", str(MOE_BATCH_WORDS)]


def moe_param_shapes(torch, udgen):
    """The leaf shapes train:moe updates: trf.cfg with 8 experts, labels
    collected from the udgen corpus as ``train()`` collects them."""
    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training import corpus  # noqa: F401  (spacy.Corpus.v1)

    cfg = trf_full_config()
    cfg["components"]["transformer"]["model"]["n_experts"] = MOE_EXPERTS
    cfg["paths"] = {"train": str(udgen[0]), "dev": str(udgen[0])}
    cfg = cfg.interpolate()
    nlp = Pipeline.from_config(cfg, device="cpu")
    nlp.initialize(registry.resolve(cfg["corpora"]["train"]), seed=0)
    return [tuple(p.shape) for p in nlp.model.parameters()]


@contextmanager
def moe_recorder(calls, replay=None):
    """Every ``moe_ffn`` call appends (routing, real tokens, kept, aux) to
    ``calls``, the routing recomputed from the call's inputs as the layer
    computes it. With ``replay`` (the routings of an earlier run, in call
    order) each call routes its tokens as that run did: its ``argmax`` is
    the recorded one (the gradient check holds two runs of the same
    function, the kernels' and the plain versions', to the same routing)."""
    import torch

    import spacy_ray_tpu_torch.models.transformer as TR

    real = TR.moe_ffn
    pending = [r[0] for r in replay or []]

    def recording(w, h, token_mask, *, capacity_factor, compute_dtype):
        with torch.no_grad():
            idx = torch.argmax(torch.softmax(h @ w("router_W"), dim=-1), dim=-1)
        if replay is None:
            out, aux = real(w, h, token_mask, capacity_factor=capacity_factor,
                            compute_dtype=compute_dtype)
        else:
            forced = pending.pop(0)
            with mock.patch.object(torch, "argmax", lambda x, dim=-1: forced):
                out, aux = real(w, h, token_mask, capacity_factor=capacity_factor,
                                compute_dtype=compute_dtype)
        with torch.no_grad():
            E = w("e_W1").shape[0]
            onehot = torch.nn.functional.one_hot(idx, E).float() * token_mask.float()[:, None]
            arrival = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
            kept = (arrival < TR.moe_capacity(capacity_factor, h.shape[0], E)) & token_mask
            calls.append((idx.clone(), int(token_mask.sum()), int(kept.sum()),
                          float(aux.detach())))
        return out, aux

    with mock.patch.object(TR, "moe_ffn", recording):
        yield
    if pending:
        raise RuntimeError(f"{len(pending)} recorded routings were not replayed")


def phase_train_moe(torch, udgen, moe_shapes):
    """``python -m spacy_ray_tpu_torch train configs/trf.cfg
    --components.transformer.model.n_experts 8`` (``moe_cli_args``; its
    ``main`` in this process, counters zeroed just before and read just
    after): K1 fwd/bwd, K2, K3 and K5 launched, every head's loss falling,
    ``loss_aux`` finite every step, two checkpoint generations, the leaves
    those K5 was held at. Then, on one microbatch: ``loss_aux`` against
    ``router_aux_weight`` x the layers' aux from a recompute, the share of
    real tokens dropped at capacity per layer, one step's device time by
    part under ``torch.profiler``, and every leaf's gradient with the
    kernels against the plain versions (the expert and router leaves held
    when no token routes differently between the two runs)."""
    from torch.profiler import ProfilerActivity, profile

    from spacy_ray_tpu_torch.__main__ import main as cli
    from spacy_ray_tpu_torch.models.core import Context
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training import loop
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length
    from spacy_ray_tpu_torch.training.checkpoint import Checkpoints

    phase = "train:moe"
    work = WORK / "train_moe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = work / "out"
    captured = {}
    real_train = loop.train

    def recording_train(*a, **k):
        captured["run"] = real_train(*a, **k)
        return captured["run"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(loop, "train", recording_train), \
            redirect_stdout(io.StringIO()) as said:
        rc = cli(moe_cli_args(udgen, out))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    printed = said.getvalue().strip().splitlines()
    if rc != 0 or not any(line.startswith(f"Done. steps={MOE_STEPS}") for line in printed):
        fail(f"{phase}: train exited {rc}: {printed[-3:]}")
    nlp, result = captured["run"]
    need = ["hash_embed_gather_sum", "hash_embed_table_grad", "flash_attention_fwd",
            "flash_attention_bwd", "fused_update"]
    missing = [k for k in need if launches[k] == 0]
    if missing:
        fail(f"{phase}: kernels never launched on the training path: {missing}")
    if len(result.step_head_losses) != MOE_STEPS:
        fail(f"{phase}: {len(result.step_head_losses)} steps' losses, expected {MOE_STEPS}")
    head_losses = {}
    for head in ("tagger", "parser", "ner", "aux"):
        xs = [step[head] for step in result.step_head_losses]
        if not all(math.isfinite(x) for x in xs):
            fail(f"{phase}: loss_{head} is not finite: {xs}")
        first, last = statistics.mean(xs[:5]), statistics.mean(xs[-5:])
        head_losses[head] = {"first5_mean": first, "last5_mean": last, "ratio": last / first}
        if head != "aux" and not last < first:
            fail(f"{phase}: loss_{head} did not fall: {first} -> {last}")
    gens = Checkpoints(out / "last-model").generations()
    if gens != [MOE_EVAL, MOE_STEPS]:
        fail(f"{phase}: checkpoint generations {gens}, expected {[MOE_EVAL, MOE_STEPS]}")
    trained_shapes = [tuple(p.shape) for p in nlp.model.parameters()]
    if trained_shapes != moe_shapes:
        fail(f"{phase}: trained {len(trained_shapes)} leaves, not the "
             f"{len(moe_shapes)} leaves K5 was held at")
    event_ms = [a.elapsed_time(b) for a, b in result.step_events]

    # one microbatch (the corpus's first, as the loop pads it)
    cfg_i = nlp.config.interpolate()
    batcher = registry.resolve(cfg_i["training"]["batcher"])
    corpus = registry.resolve(cfg_i["corpora"]["train"])
    raw = list(zip(range(3), batcher(corpus())))
    B_pad = bucket_batch_size(max(len(b) for _, b in raw))
    T_pad = max(bucket_length(max(len(eg) for eg in b)) for _, b in raw)
    collated = [nlp.collate(b, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
                for _, b in raw]
    c = collated[0]
    trunk = nlp.components["transformer"].model
    calls = []
    with moe_recorder(calls), torch.no_grad():
        _, metrics = nlp.loss(c["tokens"], c["targets"], dropout=0.0)
        sink = []
        trunk(c["tokens"], ctx=Context(aux_losses=sink))
    depth = trunk.dims["depth"]
    loss_aux = float(metrics["loss_aux"])
    recompute = trunk.router_aux_weight * sum(a for *_, a in calls[depth:2 * depth])
    if not (math.isfinite(loss_aux)
            and abs(loss_aux - recompute) <= TOL_MOE_AUX * abs(recompute)):
        fail(f"{phase}: loss_aux {loss_aux} != router_aux_weight x the layers' aux {recompute}")
    dropped = [1.0 - kept / max(real, 1) for _, real, kept, _ in calls[:depth]]

    # one step (3 microbatches + K5) under the profiler: device time by part
    nlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}
    optimizer = registry.resolve(cfg_i["training"]["optimizer"])
    opt_state = optimizer.init(params)

    def one_step():
        # gradients zeroed in place, as the loop's step zeroes them: new
        # gradient tensors would make K5 rebuild its chunk table every step
        for p in params.values():
            if p.grad is not None:
                p.grad.zero_()
        for b in collated:
            nlp.loss(b["tokens"], b["targets"], dropout=0.1, seed=7)[0].backward()
        grads = {k: p.grad for k, p in params.items()}
        torch._foreach_div_(list(grads.values()), float(len(collated)))
        with torch.no_grad():
            optimizer.update(params, grads, opt_state)

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    one_step()
    # the idle share divides the profiled step's device time by an
    # unprofiled step's wall time: the profiler's own host cost stretches
    # the step it traces
    step_wall_ms = statistics.median(timed_step() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = timed_step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = prof.key_averages()
    device = [e for e in rows if str(getattr(e, "device_type", "")).endswith("CUDA")]
    ops = {e.key: dev_us(e) / 1e3 for e in rows
           if not str(getattr(e, "device_type", "")).endswith("CUDA")}
    busy_ms = sum(dev_us(e) for e in device) / 1e3
    # attributed by kernel name (the port's kernels) or by operator (the
    # MoE's library calls; an index or a cat elsewhere in the step counts too)
    groups = {"expert_bmm": ("aten::bmm",),
              "dispatch_combine": ("aten::index", "aten::_index_put_impl_", "aten::scatter_",
                                   "aten::cat"),
              "router": ("aten::_softmax", "aten::_softmax_backward_data", "aten::argmax",
                         "aten::cumsum", "aten::gather")}
    split = {name: sum(ops.get(k, 0.0) for k in keys) for name, keys in groups.items()}
    split["attention_k2_k3"] = sum(dev_us(e) for e in device if "flash" in e.key) / 1e3
    split["k5_fused_update"] = sum(dev_us(e) for e in device
                                   if "fused_update" in e.key) / 1e3
    split["other"] = busy_ms - sum(split.values())

    # every leaf's gradient with the kernels and with their plain versions,
    # the plain run routing every token as the kernels' run did: a token
    # that crosses a near-tie to another expert would change every leaf's
    # gradient below it, which is no measure of the kernels. Remat off: its
    # recompute stops once the saved tensors are back, mid-layer (remat
    # gives the same gradients: tests/test_torch_moe.py)
    b = collated[1]
    grads, routes, natural = [], [], []
    trunk.remat = False
    for plain in (False, True):
        for p in params.values():
            p.grad = None
        kernels = plain_kernels() if plain else nullcontext()
        with kernels, moe_recorder(natural if plain else routes,
                                   replay=routes if plain else None):
            nlp.loss(b["tokens"], b["targets"], dropout=0.0)[0].backward()
        grads.append({k: p.grad.detach().clone() for k, p in params.items()})
    trunk.remat = True
    rel = {k: (grads[0][k] - grads[1][k]).abs().max().item()
           / max(grads[1][k].abs().max().item(), 1e-30) for k in params}
    flips = sum(int((a[0] != c[0]).sum()) for a, c in zip(routes, natural))
    worst = max(rel, key=rel.get)
    if not rel[worst] <= TOL_GRAD:
        fail(f"{phase}: gradient of {worst} kernels vs plain {rel[worst]} > {TOL_GRAD}")
    expert = [k for k in rel if k.rsplit("/", 1)[-1] in ("router_W", "e_W1", "e_W2")]
    worst_expert = max(expert, key=rel.get)
    del grads
    nlp.model.requires_grad_(False)
    n_leaves, n_params = len(params), sum(p.numel() for p in params.values())
    del nlp, params, optimizer, opt_state, collated, c, prof
    captured.clear()
    torch.cuda.empty_cache()
    keys = ("tag_acc", "dep_las", "ents_f")
    res = {
        "phase": phase, "argv": " ".join(moe_cli_args(("<udgen train>", "<udgen dev>"),
                                                      Path("<out>"))[:3]) + " ...",
        "seconds": seconds, "steps": result.final_step, "leaves": n_leaves,
        "params": n_params, "experts": MOE_EXPERTS, "generations": gens,
        "group_shapes_B_T": sorted(set(result.step_shapes)), "head_losses": head_losses,
        "dev_scores": [(h["step"], {k: h["other_scores"].get(k) for k in keys})
                       for h in result.history],
        "step_ms_median_events": statistics.median(event_ms),
        "step_ms_quartiles_events": statistics.quantiles(event_ms, n=4),
        "step_ms_median_host": statistics.median(x * 1e3 for x in result.step_host_seconds),
        # the loop's words/s (its evaluations and checkpoints in the time) and
        # the steps' own (their events)
        "words_per_s": result.wps, "words_per_s_steps": result.words_seen / sum(event_ms) * 1e3,
        "words": result.words_seen, "peak_memory_gb": peak_gb,
        "launches": launches, "loss_aux": loss_aux, "loss_aux_recompute": recompute,
        "dropped_share_per_layer": dropped, "microbatch_B_T": [B_pad, T_pad],
        "step_profile": {"step_wall_ms_unprofiled_median3": step_wall_ms,
                         "step_wall_ms_profiled": profiled_wall_ms,
                         "device_busy_ms": busy_ms,
                         "device_idle_share": 1.0 - busy_ms / step_wall_ms,
                         "device_idle_share_vs_loop_step_events":
                             1.0 - busy_ms / statistics.median(event_ms),
                         "split_device_ms": split,
                         "top_device_ms": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in
                                           sorted(device, key=dev_us, reverse=True)[:10]],
                         "top_ops_device_ms": sorted(ops.items(), key=lambda kv: -kv[1])[:10]},
        "grad_max_rel_err": rel[worst], "grad_worst_leaf": worst, "grad_tol": TOL_GRAD,
        "grad_expert_router_max_rel_err": rel[worst_expert],
        "grad_expert_router_worst_leaf": worst_expert,
        # routing decisions the plain run would have made otherwise (replayed)
        "grad_plain_routing_flips": flips,
        "grad_routing_decisions": sum(int(r[1]) for r in routes),
    }
    emit(res)
    return res, out


def moe_texts(dev_path):
    from spacy_ray_tpu_torch.training.corpus import Corpus

    return [" ".join(eg.reference.words) for eg in Corpus(dev_path)()
            if len(eg.reference.words) <= 60][:MOE_TEXTS]


def open_loop(port: int, texts, rps: float, seconds: float):
    """One-text requests sent at ``rps`` a second for ``seconds``, each at
    its scheduled time on its own thread: [(text, latency s, status, body)]."""
    out, lock = [], threading.Lock()
    t_start = time.perf_counter()
    n = int(rps * seconds)

    def send(i):
        text = texts[i % len(texts)]
        status, body = post(port, [text])
        with lock:
            out.append((text, time.perf_counter() - (t_start + i / rps), status, body))

    threads = []
    for i in range(n):
        delay = t_start + i / rps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=send, args=(i,))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    return out


def moe_server(model_dir: Path, *extra):
    """``serve`` (its ``build_server``) on ``model_dir``, started and warmed:
    (server, port, seconds)."""
    from spacy_ray_tpu_torch.__main__ import build_server

    t = time.perf_counter()
    server = build_server([str(model_dir), "--port", "0", *MOE_SERVE, *extra])
    _, port = server.start()
    server.engine.start()
    return server, port, time.perf_counter() - t


def stop_server(torch, server):
    server.request_shutdown()
    if server.wait() != 0:
        fail("the MoE server did not drain cleanly")
    del server
    torch.cuda.empty_cache()


def moe_vs_cpu(cpu, answers, done=None) -> dict:
    """The served one-text answers against the same model on the CPU at the
    same (B, T) bucket (an expert's capacity depends on it): the share of
    tokens whose tag, head and dep agree, and the entity sets' F. ``done``
    keeps the CPU's docs by (text, B, T) across calls."""
    done = {} if done is None else done
    got, want = [], []
    for text, body in answers:
        key = (text, body["batch"]["B"], body["batch"]["T"])
        if key not in done:
            d = cpu.tokenizer(text)
            cpu.predict_docs([d], batch_size=1, pad_batch_to=key[1], pad_len_to=key[2])
            done[key] = d
        got.append(body["docs"][0])
        want.append(done[key])
    out = {}
    for key in ("tags", "heads", "deps"):
        pairs = [(a, b) for s, d in zip(got, want) for a, b in zip(s[key], getattr(d, key))]
        out[key] = sum(a == b for a, b in pairs) / len(pairs)
    out["ents_f"] = set_f({(i, *e[:3]) for i, s in enumerate(got) for e in s.get("ents", [])},
                          {(i, e.start, e.end, e.label) for i, d in enumerate(want)
                           for e in d.ents})
    return out


def moe_refusal_label(params) -> str:
    """The JAX package's int8 refusal label for an MoE trunk
    (``spacy_ray_tpu/serving/overlay.py``), written out from the leaf names."""
    layers = sorted(int(k[len("layer_"):]) for k in params["transformer"]
                    if k.startswith("layer_"))
    moe = [f"transformer/layer_{i}/{k}" for i in layers for k in ("e_W1", "e_W2")]
    return (f"f32 (overlay refused: {len(moe)} MoE expert weight leaf(s) outside int8 "
            f"coverage ({', '.join(moe[:4])}" + (", ..." if len(moe) > 4 else "") + "))")


def replay_batches(torch, phase, stream, batches, model_dir: Path, ckpt_dir: Path, *,
                   max_batch_docs: int, max_doc_len: int, texts=()):
    """Every served batch replayed as one request of its docs, in order, on a
    fresh engine of the generation its responses are stamped with (``None``:
    ``model_dir`` as loaded; a stamp: ``model_dir`` with that generation's
    params file from ``ckpt_dir``; its own decode graphs). ``stream`` maps a
    request id to (texts, status, body), ``batches`` lists each batch's
    request ids (from its ``/trace`` span). Fails unless every request ran in
    a batch, each batch holds one generation, and each response equals its
    share of the replay bit for bit and ran at the same (B, T, occupancy).
    Returns (batches by generation, each generation's one-text answers for
    ``texts``, its fresh engine's setup seconds, the replays)."""
    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.pipeline.doc import doc_to_json
    from spacy_ray_tpu_torch.serving.engine import InferenceEngine

    ran = sorted(rid for b in batches for rid in b)
    if ran != sorted(stream):
        fail(f"{phase}: {len(stream)} responses, {len(ran)} requests in batch spans")
    per_gen = {}
    for b in batches:
        gens = {stream[rid][2]["batch"]["generation"] for rid in b}
        if len(gens) != 1 or any(stream[rid][1] != 200 for rid in b):
            fail(f"{phase}: a batch of {len(b)} requests stamped {gens}")
        per_gen.setdefault(gens.pop(), []).append(b)
    fresh_one, fresh_s, replays = {}, {}, 0
    for gen, gen_batches in per_gen.items():
        t = time.perf_counter()
        src = model_dir
        if gen is not None:
            # model_dir with the generation's params file in place of its own:
            # one read where from_disk + load_params take two
            src = WORK / f"{phase.replace(':', '_')}_generation_{gen}"
            shutil.rmtree(src, ignore_errors=True)
            src.mkdir(parents=True)
            for f in model_dir.iterdir():
                if f.name != "params.npz":
                    (src / f.name).symlink_to(f.resolve())
            (src / "params.npz").symlink_to((ckpt_dir / f"params-{gen}.npz").resolve())
        nlp = Pipeline.from_disk(src, device="cuda")
        fresh = InferenceEngine(nlp, max_batch_docs=max_batch_docs,
                                max_doc_len=max_doc_len).start()
        fresh_s[gen] = time.perf_counter() - t
        fresh_one[gen] = {t: json.dumps([doc_to_json(d) for d in fresh.submit_texts([t]).docs])
                          for t in texts}
        ran_as = {}  # the clients repeat their requests: one replay per batch's texts
        for b in gen_batches:
            key = tuple(t for rid in b for t in stream[rid][0])
            if key not in ran_as:
                ref = fresh.submit_texts(list(key))
                ran_as[key] = (ref.batch_info, [doc_to_json(d) for d in ref.docs])
                replays += 1
            info, docs = ran_as[key]
            for rid in b:
                sent, _, body = stream[rid]
                want, docs = docs[:len(sent)], docs[len(sent):]
                got = {k: body["batch"][k] for k in ("B", "T", "occupancy")}
                if got != {k: info[k] for k in got}:
                    fail(f"{phase}: {rid} ran at {got}, its batch at {info}")
                if json.dumps(body["docs"]) != json.dumps(want):
                    fail(f"{phase}: {rid} stamped {gen} (a batch of {len(b)} requests) "
                         "differs from that generation's fresh engine")
        fresh.stop()
        del fresh, nlp
        torch.cuda.empty_cache()
        if src != model_dir:
            shutil.rmtree(src)
    return per_gen, fresh_one, fresh_s, replays


def phase_slice_moe(torch, out: Path, dev_path: Path):
    """train:moe's ``best-model`` through the serving entry point. slice:moe:
    at ``--precision auto`` (bf16) under a fixed open-loop load (p50, p99),
    every doc tagged and parsed; at ``f32``, one request at a time, the
    answers against the CPU's >= ``FLOOR_MOE_F32`` (bf16's reported, held
    at ``FLOOR_MOE_BF16``); ``--precision int8`` refused with the JAX
    package's label and ``/healthz`` saying f32. serve:telemetry: the same
    server's ``/metrics`` keys and request counters, the Prometheus text
    parsed, ``/trace`` a Chrome trace with one span per batch, and p50 with
    ``--no-telemetry`` at the same load. serve:swap: on the same server,
    ``/admin/swap`` to the first generation, then to the second while
    ``SWAP_CLIENTS`` clients send ``SWAP_TEXTS``-text requests: every batch
    (its requests from its ``/trace`` span) holds one generation, and each
    response equals, bit for bit, that batch run on a fresh engine of the
    generation it is stamped with (best-model's directory with that
    generation's params file; its own decode graphs);
    ``/admin/rollback`` gives the first generation's bytes again; 403
    outside the allowlist, 409 for a torn generation; stage and flip
    seconds."""
    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.training.checkpoint import Checkpoints

    best, last = out / "best-model", out / "last-model"
    texts = moe_texts(dev_path)
    g1, g2 = Checkpoints(last).generations()
    # a torn generation: the meta of generation g2 over a truncated params file
    torn = WORK / "moe_torn"
    shutil.rmtree(torn, ignore_errors=True)
    torn.mkdir(parents=True)
    with open(last / f"params-{g2}.npz", "rb") as f:
        (torn / f"params-{g2}.npz").write_bytes(f.read(1 << 20))
    shutil.copy(last / f"train_meta-{g2}.json", torn)

    server, port, setup_s = moe_server(best, "--swap-dir", str(last), "--swap-dir", str(torn))
    runs = {}
    try:
        # one request at a time (an expert's capacity depends on the batch),
        # for the comparison with the CPU
        bf16_answers = [(t, post(port, [t])[1]) for t in texts]
        _cuda.reset_launch_counts()
        load = open_loop(port, texts, MOE_RPS, MOE_LOAD_S)
        torch.cuda.synchronize()
        runs["slice:moe"] = {"launches": _cuda.launch_counts()}
        bad = [(s, b) for _, _, s, b in load if s != 200 or not all(
            d.get("tags") and d.get("heads") is not None and d.get("deps")
            for d in b["docs"])]
        if bad:
            fail(f"slice:moe: {len(bad)} bad answers, e.g. {bad[0]}")
        missing = [k for k in ("hash_embed_gather_sum", "flash_attention_fwd")
                   if runs["slice:moe"]["launches"][k] == 0]
        if missing:
            fail(f"slice:moe: kernels never launched on the serving path: {missing}")
        lat_on = sorted(x[1] * 1e3 for x in load)
        health = get(port, "/healthz")[1]

        # serve:telemetry on the same server
        _, snap = get(port, "/metrics")
        need = {"counters", "gauges", "histograms", "slo", "slo_window", "process",
                "generation", "swap_count"}
        sent = len(texts) + len(load)
        if not need <= set(snap) or snap["counters"]["requests"] != sent:
            fail(f"serve:telemetry: /metrics keys {sorted(snap)} or requests "
                 f"{snap['counters'].get('requests')} != {sent} sent")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics?format=prometheus",
                                    timeout=30) as r:
            prom = r.read().decode()
        series = 0
        for line in prom.splitlines():
            if line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
                series += 1
        _, trace = get(port, "/trace")
        spans = [e for e in trace["traceEvents"] if e.get("name") == "serve_batch"]
        if len(spans) != snap["counters"]["batches"] or not all(e["ph"] == "X" for e in spans):
            fail(f"serve:telemetry: {len(spans)} batch spans for "
                 f"{snap['counters']['batches']} batches")
        telemetry = {"metrics_keys": sorted(snap), "requests": snap["counters"]["requests"],
                     "batches": snap["counters"]["batches"], "prometheus_series": series,
                     "trace_batch_spans": len(spans),
                     "slo": snap["slo"], "p50_ms_telemetry_on": percentile(lat_on, 0.5)}

        # serve:swap on the same server, under SWAP_CLIENTS clients sending
        # SWAP_TEXTS-text requests back to back, so a batch holds one or two
        # requests (max-batch 4) and runs at the B 2 or B 4 bucket's graphs
        def one_by_one():
            return [(t, post(port, [t])) for t in texts]

        forbidden = post_status(port, "/admin/swap", {"dir": str(WORK)})
        torn_status = post_status(port, "/admin/swap", {"dir": str(torn), "generation": g2})
        if forbidden != 403 or torn_status != 409:
            fail(f"serve:swap: a dir outside the allowlist answered {forbidden}, "
                 f"a torn generation {torn_status}")
        first = admin(port, "/admin/swap", {"dir": str(last), "generation": g1})
        r1 = {t: json.dumps(b["docs"]) for t, (s, b) in one_by_one()}
        _cuda.reset_launch_counts()
        stream, stop, lock = {}, threading.Event(), threading.Lock()

        def client(c):
            i = 0
            while not stop.is_set():
                k = (i * SWAP_CLIENTS + c) * SWAP_TEXTS
                sent = [texts[(k + j) % len(texts)] for j in range(SWAP_TEXTS)]
                rid = f"swap-{c}-{i}"
                status, body = post(port, sent, request_id=rid)
                with lock:
                    stream[rid] = (sent, status, body)
                i += 1

        clients = [threading.Thread(target=client, args=(c,)) for c in range(SWAP_CLIENTS)]
        for th in clients:
            th.start()
        while len(stream) < len(texts):
            time.sleep(0.01)
        swap = admin(port, "/admin/swap", {"dir": str(last), "generation": g2})
        n_before = len(stream)
        while len(stream) < n_before + 2 * len(texts):
            time.sleep(0.01)
        stop.set()
        for th in clients:
            th.join()
        back = admin(port, "/admin/rollback", {})
        after_rollback = {t: json.dumps(b["docs"]) for t, (s, b) in one_by_one()}
        torch.cuda.synchronize()
        runs["serve:swap"] = {"launches": _cuda.launch_counts()}
        # each batch's requests, in the order their docs ran, from its span
        _, trace = get(port, "/trace")
        batches = [tuple(e["args"]["request_ids"]) for e in trace["traceEvents"]
                   if e.get("name") == "serve_batch"
                   and e.get("args", {}).get("request_ids", [""])[0] in stream]
    finally:
        stop_server(torch, server)

    per_gen, fresh_one, fresh_s, replays = replay_batches(
        torch, "serve:swap", stream, batches, best, last, max_batch_docs=4, max_doc_len=64,
        texts=texts)
    if sorted(per_gen) != [g1, g2]:
        fail(f"serve:swap: batches stamped {sorted(per_gen)}, not [{g1}, {g2}]")
    multi = {gen: sum(len(b) > 1 for b in bs) for gen, bs in per_gen.items()}
    if fresh_one[g1] != r1 or after_rollback != r1 or r1 == fresh_one[g2] or not all(
            multi.values()):
        fail(f"serve:swap: fresh {g1} bit-equal {fresh_one[g1] == r1}; rollback bit-equal "
             f"{after_rollback == r1}; the generations answer alike {r1 == fresh_one[g2]}; "
             f"batches of more than one request {multi}")
    emit({"phase": "serve:swap", "generations": [g1, g2], "clients": SWAP_CLIENTS,
          "texts_per_request": SWAP_TEXTS, "responses": len(stream),
          "stamped": {gen: sum(len(b) for b in bs) for gen, bs in per_gen.items()},
          "batches": {gen: len(bs) for gen, bs in per_gen.items()},
          "batches_of_more_than_one_request": multi, "replayed_batches": replays,
          "fresh_engine_s": fresh_s,
          # (B, T, docs, requests) of every batch in the swap window
          "batches_seen": sorted({(stream[b[0]][2]["batch"]["B"], stream[b[0]][2]["batch"]["T"],
                                   stream[b[0]][2]["batch"]["occupancy"], len(b))
                                  for b in batches}),
          "bit_equal_to_each_generation": True, "rollback_bit_equal": True,
          "forbidden_status": forbidden, "torn_status": torn_status,
          "stage_s": swap["stage_s"], "flip_s": swap["flip_s"], "flip_wait_s": swap["wait_s"],
          "first_swap_stage_s": first["stage_s"], "rollback_flip_s": back["flip_s"],
          "launches": runs["serve:swap"]["launches"]})

    # the same load with --no-telemetry
    server, port, _ = moe_server(best, "--no-telemetry")
    try:
        load_off = open_loop(port, texts, MOE_RPS, MOE_LOAD_S)
        if any(s != 200 for _, _, s, _ in load_off):
            fail("slice:moe: --no-telemetry server failed a request")
        if get(port, "/metrics")[1].get("telemetry") != "disabled":
            fail("slice:moe: --no-telemetry server reports telemetry")
    finally:
        stop_server(torch, server)
    lat_off = sorted(x[1] * 1e3 for x in load_off)
    telemetry["p50_ms_telemetry_off"] = percentile(lat_off, 0.5)
    telemetry["p99_ms_on_off"] = [percentile(lat_on, 0.99), percentile(lat_off, 0.99)]
    emit({"phase": "serve:telemetry", **telemetry})

    # f32, one request at a time, against the CPU; int8 refused
    server, port, _ = moe_server(best, "--precision", "f32")
    try:
        f32_answers = [(t, post(port, [t])[1]) for t in texts]
    finally:
        stop_server(torch, server)
    cpu = Pipeline.from_disk(best, device="cpu")
    cpu_docs = {}
    agree_f32 = moe_vs_cpu(cpu, f32_answers, cpu_docs)
    agree_bf16 = moe_vs_cpu(cpu, bf16_answers, cpu_docs)
    label = moe_refusal_label(cpu.params)
    del cpu
    low = {k: v for k, v in agree_f32.items() if not v >= FLOOR_MOE_F32}
    low.update({f"bf16_{k}": v for k, v in agree_bf16.items() if not v >= FLOOR_MOE_BF16})
    if low:
        fail(f"slice:moe: card vs CPU below the floors: {low}")
    from spacy_ray_tpu_torch.__main__ import build_server

    server = build_server([str(best), "--port", "0", *MOE_SERVE, "--precision", "int8"])
    try:
        _, port = server.start()
        server.engine.start(warmup=False)
        int8_health = get(port, "/healthz")[1]
    finally:
        stop_server(torch, server)
    if int8_health["precision"] != "f32" or int8_health["precision_label"] != label:
        fail(f"slice:moe: --precision int8 served {int8_health['precision']} "
             f"{int8_health['precision_label']!r}, not JAX's {label!r}")
    res = {"phase": "slice:moe", "setup_s": setup_s, "precision_label": health["precision_label"],
           "offered_rps": MOE_RPS, "requests": len(load),
           "p50_ms": percentile(lat_on, 0.5), "p99_ms": percentile(lat_on, 0.99),
           "batches_seen": sorted({(b["batch"]["B"], b["batch"]["T"], b["batch"]["occupancy"])
                                   for *_, b in load}),
           "card_vs_cpu_f32": agree_f32, "card_bf16_vs_cpu_f32": agree_bf16,
           "floors": {"f32": FLOOR_MOE_F32, "bf16": FLOOR_MOE_BF16},
           "int8_label": int8_health["precision_label"],
           "launches": runs["slice:moe"]["launches"]}
    emit(res)
    shutil.rmtree(torn, ignore_errors=True)
    return {"slice:moe": res, "serve:swap": runs["serve:swap"]}


def post_status(port: int, path: str, payload) -> int:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def admin(port: int, path: str, payload) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        fail(f"{path} answered {e.code}: {e.read()[:300]}")


def phase_slice_moe_jax(torch):
    """``tests/data/jax_moe`` (written by the JAX package:
    bin/make_jax_moe_fixture.py) served at f32 through the serving entry
    point, one text a request: tags, heads, deps and entities equal the JAX
    package's ``answers.json``, and the trunk's output of its first texts
    within ``TOL_MOE_JAX_TRUNK`` of JAX's."""
    import numpy as np

    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.doc import Doc, Example

    path = ROOT / "tests" / "data" / "jax_moe"
    answers = json.loads((path / "answers.json").read_text(encoding="utf8"))
    server, port, _ = moe_server(path, "--precision", "f32")
    try:
        _cuda.reset_launch_counts()
        served = [post(port, [t])[1] for t in answers["texts"]]
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
        nlp = server.engine.nlp
        trunk_err = 0.0
        for i, rows in enumerate(answers["trunk"]):
            B, T = answers["buckets"][i]
            words = list(nlp.tokenizer(answers["texts"][i]).words)
            c = nlp.collate([Example.from_gold(Doc(words=words))], pad_batch_to=B, pad_len_to=T)
            with torch.no_grad():
                X = nlp.forward(c["tokens"])["transformer"].X[0, :len(words)].cpu().numpy()
            trunk_err = max(trunk_err, float(np.abs(X - np.asarray(rows)).max()))
    finally:
        stop_server(torch, server)
    for i, body in enumerate(served):
        d, bucket = body["docs"][0], [body["batch"]["B"], body["batch"]["T"]]
        got = (d["tags"], d["heads"], d["deps"], [e[:3] for e in d.get("ents", [])], bucket)
        want = (answers["tags"][i], answers["heads"][i], answers["deps"][i],
                answers["ents"][i], answers["buckets"][i])
        if got != want:
            fail(f"slice:moe_jax: text {i} served {got}, JAX answered {want}")
    if not trunk_err <= TOL_MOE_JAX_TRUNK:
        fail(f"slice:moe_jax: trunk output {trunk_err} from JAX's > {TOL_MOE_JAX_TRUNK}")
    missing = [k for k in ("hash_embed_gather_sum", "flash_attention_fwd") if launches[k] == 0]
    if missing:
        fail(f"slice:moe_jax: kernels never launched: {missing}")
    res = {"phase": "slice:moe_jax", "texts": len(served), "answers_equal": True,
           "trunk_max_abs_err": trunk_err, "trunk_tol": TOL_MOE_JAX_TRUNK,
           "launches": launches}
    emit(res)
    return res


# ------------------------------------------- several models on one card, live

MM_SERVE = ["--max-batch", "8", "--max-doc-len", "64", "--precision", "auto"]
MM_SEGMENTS = 5            # serve:multimodel: bursts cnn, md, cnn, md, cnn: 5 loads (2 of md), 4 evictions
MM_SEGMENT_S = 1.5         # each burst's seconds once its model answers
MM_TRF_CLIENTS = 16        # closed-loop clients per trf tenant: both classes stay queued
MM_TEXTS = 32              # dev texts of <= 60 words the phase sends (max-doc-len 64)
MM_QUOTA = (5.0, 10.0)     # the metered tenant: docs a second, burst
MM_METERED_RPS = 10.0      # its 2-text requests a second, open loop: 4 x its quota
MM_SHARE = (3.2, 4.8)      # trf's served gold:batch docs (weights 4:1)
MM_MEMORY_DRIFT = 64 << 20  # allocated after the 2nd and the last eviction
MM_FREED = 0.9             # an eviction gives back this share of params + overlay
FLOOR_MM = {"trf": 0.95, "md": 0.99, "cnn": 0.99}  # slice:full's kernels-vs-plain, slice:md/cnn's
WINDOW_RPS, WINDOW_S = 100.0, 3.0  # serve:multimodel's window sub-run, open loop
WATCH_STEPS, WATCH_EVERY = 40, 10  # serve:watch's trainer: a generation every 10 steps
WATCH_CLIENTS = 4


def request(port: int, path: str, texts, headers=None, timeout: float = 300.0):
    """POST ``texts`` to ``path``: (status, body or None, headers), an HTTP
    error's status included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps({"texts": texts}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, dict(e.headers)
    return status, (json.loads(raw) if raw else None), hdrs


def engine_bytes(engine) -> int:
    """Device bytes of an engine's parameters and precision overlay."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif hasattr(x, "untyped_storage") and x.is_cuda:
            key = x.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()

    walk(engine._live)
    walk(engine.overlay.overlay or {})
    return total


def latency_ms(rows) -> dict:
    lat = sorted((t1 - t0) * 1e3 for t0, t1 in rows)
    return {"n": len(lat), "p50": percentile(lat, 0.5) if lat else None,
            "p99": percentile(lat, 0.99) if lat else None}


def phase_serve_multimodel(torch, trf_dir: Path, md_dir: Path, md_last: Path, cnn_dir: Path,
                           dev_path: Path):
    """One ``serve --model-manifest`` process over train:full's trf (the
    default, pinned), train:md's and train:cnn's models, two resident at a
    time (``--resident-models 2``), classes gold (weight 4) and batch (1),
    tenants acme (gold), bulk (batch) and metered (batch, 5 docs/s, burst
    10). ``MM_TRF_CLIENTS`` closed-loop clients per trf tenant keep both
    classes queued while two burst clients alternate md and cnn
    (``MM_SEGMENTS`` bursts: the LRU loads and evicts under trf's load), the
    metered tenant sends past its quota, and the conductor sends an unknown
    model, ETag repeats and, in md's last burst, ``/admin/swap {"model":
    "md"}`` to a generation of train:md's last-model. Fails on any 5xx or
    client error, answers below ``FLOOR_MM`` against the CPU, no capture
    while a trf batch was in flight, a gold:batch share outside
    ``MM_SHARE``, no 429 or too many admitted metered docs, no 404, a repeat
    not 304 or dispatched, md's ETags unchanged by its swap or trf's
    changed, memory after the 2nd and last eviction apart by more than
    ``MM_MEMORY_DRIFT`` or an eviction giving back less than ``MM_FREED``,
    or a model whose sequential probe launched no K1 fwd (trf: no K2). Then
    the window sub-run: cnn alone at ``--batching window --max-wait-ms 5``
    and continuous under the same open loop, the same answers."""
    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.devices import DEVICE_GATE
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.decode_graph import DecodeGraphs
    from spacy_ray_tpu_torch.training.checkpoint import Checkpoints
    from spacy_ray_tpu_torch.training.corpus import Corpus

    work = WORK / "multimodel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    manifest = work / "manifest.json"
    manifest.write_text(json.dumps({
        "default_model": "trf",
        "models": {"trf": {"path": str(trf_dir)}, "md": {"path": str(md_dir)},
                   "cnn": {"path": str(cnn_dir)}},
        "classes": {"gold": {"weight": 4, "p99_target_ms": 500}, "batch": {"weight": 1}},
        "tenants": {"acme": {"class": "gold"}, "bulk": {"class": "batch"},
                    "metered": {"class": "batch", "quota_docs_per_s": MM_QUOTA[0],
                                "quota_burst": MM_QUOTA[1]}},
    }), encoding="utf-8")
    texts = [" ".join(eg.reference.words) for eg in Corpus(dev_path)()
             if len(eg.reference.words) <= 60][:MM_TEXTS]
    t0 = time.perf_counter()
    server = build_server(["ignored", "--model-manifest", str(manifest), "--port", "0",
                           *MM_SERVE, "--resident-models", "2", "--swap-dir", str(md_last)])
    res, trf = server.residency, server.engine
    lock = threading.Lock()
    # the phase's own instruments: trf batches in flight, every capture, and
    # each load and eviction of the residency (wrapped, not changed)
    trf_inflight, captures = [0], {"total": 0, "trf_in_flight": 0}
    run_batch = trf._run_batch

    def trf_batch(requests):
        with lock:
            trf_inflight[0] += 1
        try:
            run_batch(requests)
        finally:
            with lock:
                trf_inflight[0] -= 1

    trf._run_batch = trf_batch
    capture = DecodeGraphs._capture

    def watched_capture(self, comp, X, lengths):
        with lock:
            captures["total"] += 1
            captures["trf_in_flight"] += int(trf_inflight[0] > 0)
        return capture(self, comp, X, lengths)

    loads, evictions = [], []
    factory, retire = res.engine_factory, res._retire

    def timed_factory(spec):
        before, wait0 = dict(captures), DEVICE_GATE.exclusive_wait_s
        t = time.perf_counter()
        eng = factory(spec)
        total = time.perf_counter() - t
        graphs = eng.nlp.decode_graphs
        with lock:
            loads.append({
                "model": spec.name, "at_s": t - t0, "t": (t, t + total), "load_s": total,
                "from_disk_and_build_s": total - eng.warmup_s, "warmup_s": eng.warmup_s,
                "capture_s": graphs.capture_seconds if graphs is not None else 0.0,
                "graphs": len(graphs) if graphs is not None else 0,
                "captures_with_trf_batch_in_flight":
                    captures["trf_in_flight"] - before["trf_in_flight"],
                "capture_gate_wait_s": DEVICE_GATE.exclusive_wait_s - wait0,
                "allocated_after_load": torch.cuda.memory_allocated()})
        return eng

    def timed_retire(name, eng):
        size, drain, drain_s = engine_bytes(eng), eng.drain, []

        def timed_drain(timeout):
            t = time.perf_counter()
            ok = drain(timeout)
            drain_s.append(time.perf_counter() - t)
            return ok

        eng.drain = timed_drain
        t = time.perf_counter()
        retire(name, eng)
        with lock:
            evictions.append({
                "model": name, "at_s": t - t0, "retire_s": time.perf_counter() - t,
                "drain_s": drain_s[0] if drain_s else None, "param_overlay_bytes": size,
                "released_bytes": eng.released_bytes,
                "allocated_after": eng.allocated_after_release})

    res.engine_factory, res._retire = timed_factory, timed_retire
    log = []        # (model, tenant, t0, t1, status, texts, body)
    repeats = []    # (what, first status, repeat status, first ETag, repeat ETag, id)
    stop = threading.Event()

    def send(model, tenant, ts, headers=None):
        path = "/v1/parse" if model == "trf" else f"/v1/models/{model}/parse"
        t = time.perf_counter()
        status, body, hdrs = request(port, path, ts, {"X-SRT-Tenant": tenant, **(headers or {})})
        with lock:
            log.append((model, tenant, t, time.perf_counter(), status, ts, body))
        return status, body, hdrs

    def trf_client(tenant, c):
        i = 0
        while not stop.is_set():
            k = (7 * c + i) % len(texts)
            send("trf", tenant, [texts[k], texts[(k + 1) % len(texts)]])
            i += 1

    def metered():
        # six 2-text requests at once (12 docs past the burst of 10), then
        # MM_METERED_RPS 2-text requests a second, open loop
        sent = [threading.Thread(target=send, args=("trf", "metered", texts[2 * i:2 * i + 2]))
                for i in range(6)]
        for th in sent:
            th.start()
        i, t_start = 0, time.perf_counter()
        while not stop.is_set():
            th = threading.Thread(target=send, args=(
                "trf", "metered", [texts[i % len(texts)], texts[(i + 1) % len(texts)]]))
            th.start()
            sent.append(th)
            i += 1
            time.sleep(max(t_start + i / MM_METERED_RPS - time.perf_counter(), 0.0))
        for th in sent:
            th.join()

    def repeat(model, ts, what):
        """A request, then the same with its ETag in If-None-Match."""
        s1, _, h1 = send(model, "acme", ts)
        rid = f"mm-repeat-{len(repeats)}"
        s2, _, h2 = send(model, "acme", ts, {"If-None-Match": h1.get("ETag", ""),
                                             "X-SRT-Request-Id": rid})
        repeats.append((what, s1, s2, h1.get("ETag"), h2.get("ETag"), rid))
        return h1.get("ETag")

    with mock.patch.object(DecodeGraphs, "_capture", watched_capture):
        _, port = server.start()
        trf.start()
        setup_s = time.perf_counter() - t0
        mem_start = torch.cuda.memory_allocated()
        threads = ([threading.Thread(target=trf_client, args=(tn, c))
                    for tn in ("acme", "bulk") for c in range(MM_TRF_CLIENTS)]
                   + [threading.Thread(target=metered)])
        t_traffic = time.perf_counter()
        for th in threads:
            th.start()
        unknown = send("nope", "acme", texts[:1])[0]
        trf_tag = repeat("trf", texts[:2], "trf")
        swap, md_tags = None, {}
        md_gen = Checkpoints(md_last).generations()[0]
        for k in range(MM_SEGMENTS):
            model = "cnn" if k % 2 == 0 else "md"
            seg_stop = threading.Event()

            def burst(c, model=model, seg_stop=seg_stop):
                i = 0
                while not seg_stop.is_set():
                    send(model, ("acme", "bulk")[c], [texts[(11 * c + i) % len(texts)]])
                    i += 1

            t_seg = time.perf_counter()
            bursts = [threading.Thread(target=burst, args=(c,)) for c in range(2)]
            for th in bursts:
                th.start()
            while not any(r[0] == model and r[2] >= t_seg and r[4] == 200 for r in list(log)):
                if time.perf_counter() - t_seg > 240:
                    fail(f"serve:multimodel: {model} never answered")
                time.sleep(0.01)
            repeat("trf", texts[:2], "trf")
            if k == MM_SEGMENTS - 2:  # md's last burst: a swap of md alone
                md_tags["before"] = repeat("md", texts[2:3], "md before swap")
                swap = admin(port, "/admin/swap", {"model": "md", "dir": str(md_last),
                                                   "generation": md_gen})
                s, body, h = send("md", "acme", texts[2:3], {"If-None-Match": md_tags["before"]})
                md_tags["after"] = (s, h.get("ETag"), body["batch"]["generation"] if body else None)
                trf_after_swap = repeat("trf", texts[:2], "trf after md's swap")
            time.sleep(max(MM_SEGMENT_S - (time.perf_counter() - t_seg), 0.0))
            seg_stop.set()
            for th in bursts:
                th.join()
        stop.set()
        for th in threads:
            th.join()
        traffic_s = time.perf_counter() - t_traffic
        n_evictions = len(evictions)
        served_by_class = dict(trf.batcher.served_docs_by_class)
        trf_metrics = trf.tel.snapshot()["counters"]
        _, trace = get(port, "/trace")
        _, health = get(port, "/healthz")
        # sequential probes: one request a model, nothing else running
        probes = {}
        for model in ("cnn", "md", "trf"):
            admin(port, "/admin/models/load", {"model": model})
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            status, _, _ = request(port, f"/v1/models/{model}/parse", texts[:2])
            torch.cuda.synchronize()
            probes[model] = _cuda.launch_counts()
            if status != 200:
                fail(f"serve:multimodel: the {model} probe answered {status}")
        server.request_shutdown()
        if server.wait() != 0:
            fail("serve:multimodel: the server did not drain cleanly")
    del server, res, trf
    torch.cuda.empty_cache()

    # -- the checks: every one is read, the phase's line emitted, then any
    # problem fails the phase
    problems = []
    bad = [(m, tn, s) for m, tn, _, _, s, _, _ in log
           if not (s == 200 or (tn == "metered" and s == 429) or (m == "nope" and s == 404)
                   or s == 304)]
    if bad:
        problems.append(f"{len(bad)} failed requests, e.g. {bad[:5]}")
    if unknown != 404:
        problems.append(f"an unknown model answered {unknown}")
    not_304 = [r for r in repeats if r[1] != 200 or r[2] != 304]
    dispatched = {rid for e in trace["traceEvents"] if e.get("name") == "serve_batch"
                  for rid in e.get("args", {}).get("request_ids", [])}
    if not_304 or any(r[5] in dispatched for r in repeats if r[2] == 304):
        problems.append(f"repeats {not_304} not answered 304, or dispatched")
    trf_tags = {r[3] for r in repeats if r[0].startswith("trf")}
    if (len(trf_tags) != 1 or md_tags["after"][0] != 200 or md_tags["after"][1] == md_tags[
            "before"] or md_tags["after"][2] != md_gen or trf_after_swap != trf_tag):
        problems.append(f"ETags: trf {trf_tags}, md before {md_tags['before']} "
             f"after {md_tags['after']}")
    if trf_metrics.get("not_modified") != sum(r[2] == 304 for r in repeats
                                              if r[0].startswith("trf")):
        problems.append(f"trf counted {trf_metrics.get('not_modified')} 304s")
    share = served_by_class.get("gold", 0) / max(served_by_class.get("batch", 0), 1)
    if not MM_SHARE[0] <= share <= MM_SHARE[1]:
        problems.append(f"trf served gold:batch {served_by_class} ({share:.2f})")
    metered_rows = [r for r in log if r[1] == "metered"]
    admitted = sum(len(r[5]) for r in metered_rows if r[4] == 200)
    metered_s = max(r[3] for r in metered_rows) - min(r[2] for r in metered_rows)
    limit = MM_QUOTA[1] + MM_QUOTA[0] * metered_s + 1
    if not any(r[4] == 429 for r in metered_rows) or admitted > limit:
        problems.append(f"metered admitted {admitted} docs in {metered_s:.1f} s "
             f"(limit {limit:.1f}), refused {sum(r[4] == 429 for r in metered_rows)}")
    reloads = [ld for ld in loads if ld["model"] in ("md", "cnn")]
    if n_evictions < 4 or len(reloads) < MM_SEGMENTS:
        problems.append(f"{len(reloads)} loads, {n_evictions} evictions under load")
    if not any(ld["captures_with_trf_batch_in_flight"] for ld in reloads):
        problems.append(f"no reload captured while a trf batch was in flight {loads}")
    drift = abs(evictions[1]["allocated_after"] - evictions[n_evictions - 1]["allocated_after"])
    short = [e for e in evictions if not e["released_bytes"] >= MM_FREED * e[
        "param_overlay_bytes"]]
    if drift > MM_MEMORY_DRIFT or short:
        problems.append(f"memory after the 2nd and last eviction apart by {drift} B, "
             f"or evictions that gave back too little: {short}")
    missing = [m for m in probes if probes[m]["hash_embed_gather_sum"] == 0]
    if missing or probes["trf"]["flash_attention_fwd"] == 0:
        problems.append(f"sequential probes {probes}")
    # the answers against the CPU: each model directory (md also at its
    # swapped generation) on the CPU over the texts it answered
    agree = {}
    for model, src in (("trf", trf_dir), ("md", md_dir), ("cnn", cnn_dir)):
        cpu = Pipeline.from_disk(src, device="cpu")
        for gen in sorted({r[6]["batch"]["generation"] for r in log
                           if r[0] == model and r[4] == 200}, key=lambda g: g or -1):
            if gen is not None:
                cpu.load_params(Checkpoints(md_last).load_generation_params(gen)["params"])
            rows = [r for r in log if r[0] == model and r[4] == 200
                    and r[6]["batch"]["generation"] == gen]
            unique = sorted({t for r in rows for t in r[5]})
            docs = {t: cpu.tokenizer(t) for t in unique}
            cpu.predict_docs(list(docs.values()), batch_size=16)
            got = [d for r in rows for d in r[6]["docs"]]
            want = [docs[t] for r in rows for t in r[5]]
            agree[f"{model}@{gen}"] = a = agreement(cpu, got, want)
            low = {k: v for k, v in a.items() if v < FLOOR_MM[model]}
            if low:
                problems.append(f"{model} at generation {gen} against the CPU: {low}")
        del cpu
    loads_out = [{k: v for k, v in ld.items() if k != "t"} for ld in loads]
    windows = [ld["t"] for ld in reloads]
    trf_ok = [r for r in log if r[0] == "trf" and r[4] == 200 and r[1] != "metered"]
    during = [r for r in trf_ok if any(a < r[3] and r[2] < b for a, b in windows)]
    outside = [r for r in trf_ok if r not in during]
    lat = {f"{m}/{tn}": latency_ms([(r[2], r[3]) for r in log
                                    if r[0] == m and r[1] == tn and r[4] == 200])
           for m in ("trf", "md", "cnn") for tn in ("acme", "bulk", "metered")
           if any(r[0] == m and r[1] == tn and r[4] == 200 for r in log)}
    statuses = {}
    for r in log:
        statuses[str(r[4])] = statuses.get(str(r[4]), 0) + 1
    result = {
        "phase": "serve:multimodel", "setup_s": setup_s, "traffic_s": traffic_s,
        "requests": len(log), "statuses": statuses, "latency_ms": lat,
        "trf_latency_ms_during_reloads": latency_ms([(r[2], r[3]) for r in during]),
        "trf_latency_ms_outside_reloads": latency_ms([(r[2], r[3]) for r in outside]),
        "served_docs_by_class": served_by_class, "gold_to_batch": share,
        "metered": {"admitted_docs": admitted, "seconds": metered_s, "limit": limit,
                    "refused": sum(r[4] == 429 for r in metered_rows)},
        "repeats_304": sum(r[2] == 304 for r in repeats), "unknown_model_status": unknown,
        "md_swap": {k: swap[k] for k in ("generation", "stage_s", "flip_s", "wait_s")},
        "md_etag_changed": md_tags["after"][1] != md_tags["before"],
        "loads": loads_out, "evictions": evictions, "evictions_under_traffic": n_evictions,
        "memory_drift_bytes": drift, "allocated_at_start": mem_start,
        "captures": captures, "gate": {"exclusive": DEVICE_GATE.exclusive_acquisitions,
                                       "contended": DEVICE_GATE.contended,
                                       "exclusive_wait_s": DEVICE_GATE.exclusive_wait_s},
        "residency": health["residency"], "card_vs_cpu": agree, "floors": FLOOR_MM,
        "probes": probes,
        "launches": {k: sum(p[k] for p in probes.values()) for k in probes["trf"]},
        "problems": problems,
    }
    emit(result)
    if problems:
        fail("serve:multimodel: " + "; ".join(problems))
    result["window"] = phase_window_batching(torch, cnn_dir, texts)
    return result


def phase_window_batching(torch, cnn_dir: Path, texts) -> dict:
    """train:cnn's model alone, ``--batching window --max-wait-ms 5`` and
    continuous, each under ``WINDOW_RPS`` one-text requests a second for
    ``WINDOW_S`` s: the same answer for every text, occupancy and latency
    side by side."""
    from spacy_ray_tpu_torch.__main__ import build_server

    runs = {}
    for mode in ("window", "continuous"):
        server = build_server([str(cnn_dir), "--port", "0", "--max-batch", "8",
                               "--max-doc-len", "128", "--batching", mode,
                               "--max-wait-ms", "5"])
        _, port = server.start()
        server.engine.start()
        try:
            load = open_loop(port, texts, WINDOW_RPS, WINDOW_S)
            _, snap = get(port, "/metrics")
        finally:
            stop_server(torch, server)
        if len(load) != int(WINDOW_RPS * WINDOW_S) or any(s != 200 for _, _, s, _ in load):
            fail(f"serve:multimodel window sub-run: {mode} failed requests")
        answers = {}
        for text, _, _, body in load:
            answers.setdefault(text, set()).add(json.dumps(body["docs"]))
        c = snap["counters"]
        lat = sorted(x[1] * 1e3 for x in load)
        runs[mode] = {"answers": answers, "mean_occupancy": c["docs"] / c["batches"],
                      "batches": c["batches"], "p50_ms": percentile(lat, 0.5),
                      "p99_ms": percentile(lat, 0.99)}
    if runs["window"]["answers"] != runs["continuous"]["answers"] or any(
            len(v) != 1 for v in runs["window"]["answers"].values()):
        fail("serve:multimodel window sub-run: window and continuous answers differ")
    out = {"phase": "serve:multimodel:window", "offered_rps": WINDOW_RPS, "seconds": WINDOW_S,
           **{mode: {k: v for k, v in r.items() if k != "answers"} for mode, r in runs.items()},
           "answers_equal": True}
    emit(out)
    return out


def phase_serve_watch(torch, cnn_dir: Path, corpus, cnn_step_ms, beside=None,
                      keep: Path = None) -> dict:
    """``python -m spacy_ray_tpu_torch serve <train:cnn's model> --watch
    <out>/last-model --watch-interval-s 0.5`` beside ``python -m
    spacy_ray_tpu_torch train configs/cnn.cfg`` (``WATCH_STEPS`` steps, a
    generation every ``WATCH_EVERY``, all kept) on the same card while
    ``WATCH_CLIENTS`` clients send 2-text requests; after the trainer a torn
    generation (a higher stamp, its params file cut short) is planted. Fails
    unless the trainer exits 0, the watcher flips at least twice, no client
    sees its generation go back, the torn stamp is never served and logged
    once, every request succeeds, and every batch replays bit-equal on a
    fresh engine of its stamped generation (``replay_batches``). ``beside``
    runs once the server and the trainer are started: the whole phase runs
    beside it. ``keep``: a directory that receives the last generation's
    params file and meta (serve:fleet rolls it out)."""
    import os
    import signal

    from spacy_ray_tpu_torch.training.checkpoint import Checkpoints

    work = WORK / "watch"
    shutil.rmtree(work, ignore_errors=True)
    out, t0 = work / "out", time.perf_counter()
    ckpt = out / "last-model"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cli = [sys.executable, "-m", "spacy_ray_tpu_torch"]
    serve = subprocess.Popen(
        cli + ["serve", str(cnn_dir), "--port", "0", "--max-batch", "8", "--max-doc-len", "128",
               "--watch", str(ckpt), "--watch-interval-s", "0.5"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    lines, errors, ready = [], [], threading.Event()

    def read(pipe, into, flag=None):
        for line in pipe:
            into.append(line.rstrip())
            if flag is not None and "ready" in line:
                flag.set()
        if flag is not None:
            flag.set()

    readers = [threading.Thread(target=read, args=(serve.stdout, lines, ready), daemon=True),
               threading.Thread(target=read, args=(serve.stderr, errors), daemon=True)]
    for th in readers:
        th.start()
    trainer = evaluator = None
    try:
        # the trainer comes up beside the server (each process spends its
        # first seconds importing); its first generation lands after the
        # server is warm, and one already there is adopted at the watcher's start
        trainer = subprocess.Popen(
            cli + ["train", "configs/cnn.cfg", "--output", str(out), "--paths.train",
                   str(corpus[0]), "--paths.dev", str(corpus[1]),
                   "--training.max_steps", str(WATCH_STEPS),
                   "--training.eval_frequency", str(WATCH_EVERY),
                   "--training.keep_checkpoints", str(WATCH_STEPS // WATCH_EVERY + 1)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        t_train = time.perf_counter()
        if beside is not None:
            beside()
        ready.wait(timeout=300)
        ports = [int(l.rsplit(":", 1)[1]) for l in lines if l.startswith("serving on http://")]
        if not ports or serve.poll() is not None:
            fail("serve:watch: serve --watch did not come up:\n" + "\n".join(lines + errors))
        port, serve_up_s = ports[0], time.perf_counter() - t0
        from spacy_ray_tpu_torch.training.corpus import Corpus

        texts = [" ".join(eg.reference.words) for eg in Corpus(corpus[1])()
                 if len(eg.reference.words) <= 100][:24]
        stream, seqs, lock, stop = {}, [[] for _ in range(WATCH_CLIENTS)], threading.Lock(), \
            threading.Event()

        def client(c):
            i = 0
            while not stop.is_set():
                k = (i * WATCH_CLIENTS + c) * 2
                sent = [texts[k % len(texts)], texts[(k + 1) % len(texts)]]
                rid = f"watch-{c}-{i}"
                status, body, _ = request(port, "/v1/parse", sent,
                                          {"X-SRT-Request-Id": rid})
                with lock:
                    stream[rid] = (sent, status, body)
                    seqs[c].append(body["batch"]["generation"] if status == 200 else "error")
                i += 1

        clients = [threading.Thread(target=client, args=(c,)) for c in range(WATCH_CLIENTS)]
        for th in clients:
            th.start()
        train_out, _ = trainer.communicate(timeout=600)
        train_s, train_rc = time.perf_counter() - t_train, trainer.returncode
        # the trained model through the evaluate command (the trainer was the
        # train command a user runs: cli:cnn's checks), beside what follows;
        # a thread collects it, so its seconds end where the command does
        t_eval = time.perf_counter()
        evaluator = subprocess.Popen(
            cli + ["evaluate", str(out / "best-model"), str(corpus[1])], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        evaluated = {}

        def collect_evaluate():
            evaluated["out"], evaluated["err"] = evaluator.communicate()
            evaluated["s"] = time.perf_counter() - t_eval

        eval_thread = threading.Thread(target=collect_evaluate, daemon=True)
        eval_thread.start()
        gens = Checkpoints(ckpt).generations()
        last = max(gens) if gens else None
        end = time.perf_counter() + 10
        while last is not None and get(port, "/healthz")[1]["generation"] != last:
            if time.perf_counter() > end:
                break
            time.sleep(0.05)
        # a torn generation above the last: its meta names the digest of a
        # whole params file, the file is cut short
        torn = (last or 0) + WATCH_EVERY
        if last is not None:
            meta = json.loads((ckpt / f"train_meta-{last}.json").read_text(encoding="utf8"))
            data = (ckpt / f"params-{last}.npz").read_bytes()
            (ckpt / f"params-{torn}.npz").write_bytes(data[: len(data) // 2])
            meta.update(stamp=torn, step=torn, digests={
                f"params-{torn}.npz": meta["digests"][f"params-{last}.npz"]})
            (ckpt / f"train_meta-{torn}.json").write_text(json.dumps(meta), encoding="utf8")
        time.sleep(2.5)  # five polls past the torn generation
        stop.set()
        for th in clients:
            th.join()
        _, trace = get(port, "/trace")
        _, snap = get(port, "/metrics")
        _, health = get(port, "/healthz")
        serve.send_signal(signal.SIGTERM)
        serve_rc = serve.wait(timeout=120)
        for th in readers:
            th.join(timeout=10)
    except BaseException:
        if evaluator is not None and evaluator.poll() is None:
            evaluator.kill()
            evaluator.wait()
        raise
    finally:
        for proc in (serve, trainer):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    try:
        if train_rc != 0 or serve_rc != 0:
            fail(f"serve:watch: trainer exited {train_rc}, server {serve_rc}:\n{train_out}")
        failed = [rid for rid, (_, s, _) in stream.items() if s != 200]
        served = {g for seq in seqs for g in seq}
        backwards = [c for c, seq in enumerate(seqs)
                     if any((b if b is not None else -1) < (a if a is not None else -1)
                            for a, b in zip(seq, seq[1:]))]
        skipped = [l for l in errors if "[live-generation-skipped]" in l
                   and f"generation {torn} " in l]
        flips = snap["swap_count"]
        if failed or backwards or torn in served or len(skipped) != 1 or flips < 2 or \
                health["generation"] != last:
            fail(f"serve:watch: failed {failed[:5]}, clients going back {backwards}, served "
                 f"{sorted(served, key=lambda g: g or -1)}, torn {torn} logged {len(skipped)}x, "
                 f"{flips} flips, last served {health['generation']} of {gens}")
        batches = [tuple(e["args"]["request_ids"]) for e in trace["traceEvents"]
                   if e.get("name") == "serve_batch"
                   and e.get("args", {}).get("request_ids", [""])[0] in stream]
        per_gen, _, fresh_s, replays = replay_batches(
            torch, "serve:watch", stream, batches, cnn_dir, ckpt, max_batch_docs=8,
            max_doc_len=128)
        # each flip's wall time from its trace span and the anchor, against the
        # generation's meta file
        anchor = trace["anchor"]

        def wall(ts_us):
            return anchor["unix_now"] - (anchor["clock_now"] - anchor["origin"] - ts_us / 1e6)

        flips_out = []
        for e in trace["traceEvents"]:
            if e.get("name") == "swap_flip":
                gen = e["args"]["generation"]
                stage = [s for s in trace["traceEvents"] if s.get("name") == "swap_stage"
                         and s["args"]["generation"] == gen]
                meta_t = (ckpt / f"train_meta-{gen}.json").stat().st_mtime
                flips_out.append({"generation": gen,
                                  "meta_to_flip_s": wall(e["ts"] + e["dur"]) - meta_t,
                                  "stage_s": stage[0]["dur"] / 1e6 if stage else None,
                                  "flip_s": e["dur"] / 1e6})
        done = [l for l in train_out.splitlines() if l.startswith("Done.")]
        if f"Done. steps={WATCH_STEPS}" not in train_out:
            fail(f"cli:cnn: train printed no 'Done. steps={WATCH_STEPS}':\n{train_out}")
        eval_thread.join(timeout=300)
        if "s" not in evaluated:
            fail("cli:cnn: evaluate did not end within 300 s")
        eval_out, eval_err = evaluated["out"], evaluated["err"]
    except BaseException:
        if evaluator is not None and evaluator.poll() is None:
            evaluator.kill()
            evaluator.wait()
        raise
    if evaluator.returncode != 0:
        fail(f"cli:cnn: evaluate exited {evaluator.returncode}:\n{eval_err}")
    scores = json.loads(eval_out.strip().splitlines()[-1])
    if not scores.get("tag_acc", 0) > 0.5:
        fail(f"cli:cnn: evaluate scored {scores}")
    # each command from its own start to its own end; both run beside
    # serve:watch's server and serve:fleet's booting replicas on the card
    emit({"phase": "cli:cnn", "seconds": train_s + evaluated["s"],
          "train_s": train_s, "evaluate_s": evaluated["s"],
          "train_output": train_out.strip().splitlines()[-4:],
          "evaluate_output": eval_out.strip().splitlines()[-3:-1],
          "evaluate_tag_acc": scores["tag_acc"]})
    mtimes = [(ckpt / f"train_meta-{g}.json").stat().st_mtime for g in gens]
    result = {
        "phase": "serve:watch", "serve_up_s": serve_up_s, "train_s": train_s,
        "generations": gens, "torn_stamp": torn, "torn_logged": len(skipped),
        "flips": flips, "flip_detail": flips_out,
        "served_generations": sorted(served, key=lambda g: g or -1),
        "responses": len(stream), "stamped": {str(g): sum(len(b) for b in bs)
                                              for g, bs in per_gen.items()},
        "replayed_batches": replays, "fresh_engine_s": {str(g): s for g, s in fresh_s.items()},
        "bit_equal_to_each_generation": True,
        "trainer_done": done[-1] if done else None,
        "trainer_ms_per_step_between_generations":
            (mtimes[-1] - mtimes[0]) / (gens[-1] - gens[0]) * 1e3 if len(gens) > 1 else None,
        "train_cnn_step_ms_median": cnn_step_ms,
        "launches": health["kernel_launches"],  # the server process's, warmup included
    }
    emit(result)
    if keep is not None:
        keep.mkdir(parents=True, exist_ok=True)
        for name in (f"params-{last}.npz", f"train_meta-{last}.json"):
            shutil.copyfile(ckpt / name, keep / name)
    shutil.rmtree(work, ignore_errors=True)
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "spacy_ray_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no spacy_ray_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from spacy_ray_tpu_torch.devices import resolve_device
    from spacy_ray_tpu_torch.ops import _cuda

    resolve_device("cuda")
    t = time.perf_counter()
    per_source = _cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t, "per_source_s": per_source,
          "flags": " ".join(_cuda.NVCC_FLAGS),
          "ptxas": {src: ptxas_summary(_cuda.BUILD_LOGS.get(src, ""))
                    for src in ("flash_attention.cu", "flash_attention_bwd.cu",
                                "int8_matmul.cu", "hash_embed_grad.cu", "hash_embed.cu")}})
    # K5 is 24 instantiations (its branches): the main path's (Adam with
    # clipping: <1,0,0,0>) in full, the rest as their worst
    update = ptxas_summary(_cuda.BUILD_LOGS.get("fused_update.cu", ""))
    emit({"phase": "build", "ptxas": {"fused_update.cu": {
        "main_path": [r for r in update if r["kernel"] == "fused_update<1,0,0,0>"],
        "instantiations": len(update),
        "max_registers": max((r.get("registers", 0) for r in update), default=None),
        "spill_bytes": sum(r["spill_stores"] + r["spill_loads"] for r in update)}}})

    kernels = phase_kernels(torch)
    udgen = write_udgen_corpus()
    # train:faults, a supervised trainer through its drill, the longest of the
    # subprocesses, starts first, on the udgen corpus as written (.jsonl)
    faults = start_train_faults(udgen)
    spacy_corpus = write_spacy_corpus(udgen)
    # train:fleet_async, the restart drill, runs beside the work on the host
    # alone that follows (the leaf shapes of trf.cfg and its MoE, the head
    # corpora, md:assets, the CNN configs' setup), before the next kernel timings
    fleet_async = start_fleet_restart(spacy_corpus)
    # cli:train_and_serve too: a trainer and a one-replica fleet on the card
    tns = start_train_and_serve(spacy_corpus)
    try:
        full_shapes = trf_param_shapes(torch, udgen[0])
        moe_shapes = moe_param_shapes(torch, udgen)
        corpora = {"cnn": spacy_corpus, "sm": spacy_corpus, "tokcls": spacy_corpus,
                   **write_head_corpora()}
        from spacy_ray_tpu_torch.training.corpus import Corpus

        t = time.perf_counter()
        with redirect_stdout(io.StringIO()) as said:
            md_in = md_assets(spacy_corpus[0], WORK / "md")
        emit({"phase": "md:assets", "seconds": time.perf_counter() - t, **md_in[3],
              "dev_tokens": sum(len(eg) for eg in Corpus(spacy_corpus[1])()),
              "attribute_rules": len(md_in[1]), "entity_patterns": md_in[2],
              "init_vectors_said": said.getvalue().strip()})

        def md_cfg():
            return md_config(spacy_corpus, *md_in[:3])

        configs = {name: pipeline_config(name, corpora[name]) for name in corpora}
        configs["md"] = md_cfg()
        cnn = cnn_setup(torch, configs)
    except BaseException:
        from spacy_ray_tpu_torch.training.resilience import terminate_with_grace

        terminate_with_grace(fleet_async["proc"], grace_s=150.0)
        terminate_with_grace(tns["proc"], grace_s=150.0)
        terminate_with_grace(faults["proc"], grace_s=30.0)
        raise
    fleet_async_run = phase_train_fleet_restart(torch, fleet_async)
    tns_run = phase_train_and_serve(tns)
    faults_run = phase_train_faults(faults)
    kernels.update(phase_train_kernels(torch, full_shapes, moe_shapes))
    for name, rows in phase_cnn_kernels(torch, cnn).items():
        kernels[name].extend(rows)
    fleet_k5 = phase_fleet_kernels(torch, cnn)
    kernels["fused_update"].extend(fleet_k5)

    if WORK.exists():
        shutil.rmtree(WORK / "trf_tagger", ignore_errors=True)
    model_dir = build_model_dir(torch)
    runs = {p: phase_slice(torch, model_dir, p) for p in ("auto", "int8")}
    runs["train:fleet_async"] = fleet_async_run
    runs["cli:train_and_serve"] = tns_run
    runs["train:faults"] = faults_run
    # the elastic fleet: 3 workers, one SIGKILLed, the survivors re-shard; the
    # serve CLI's subprocess comes up beside the fleet's three
    runs["train:fleet_elastic"] = phase_train_fleet_elastic(
        torch, spacy_corpus, cnn, fleet_k5, beside=lambda: phase_cli(model_dir))
    shutil.rmtree(model_dir, ignore_errors=True)
    runs["train"] = phase_train(torch)
    shutil.rmtree(WORK / "train", ignore_errors=True)
    runs["train:full"], full_model = phase_train_full(torch, udgen, full_shapes)
    runs["slice:full"] = phase_slice_full(torch, full_model, udgen[1], runs["auto"])
    # train:full's and train:cnn's models stay for serve:multimodel and serve:watch
    runs["train:cnn"], cnn_model = phase_train_cnn(
        torch, "cnn", pipeline_config("cnn", corpora["cnn"]), cnn["cnn"])
    runs["slice:cnn"] = phase_slice_cnn(torch, cnn_model, spacy_corpus[1])
    # the trainer fleet: cnn.cfg as two worker processes on the card, in
    # lockstep (quorum 2, S 0); its asynchronous run came beside md:assets
    runs["train:fleet"] = phase_train_fleet(
        torch, "train:fleet", spacy_corpus, FLEET_STEPS, FLEET_N, 0,
        cnn_wps=runs["train:cnn"]["words_per_s"], cleanup=False)
    # its final generation, the owners' parts, continued by one process
    runs["train:fleet:resume"] = phase_fleet_resume(torch, WORK / "train_fleet" / "out",
                                                    spacy_corpus)
    shutil.rmtree(WORK / "train_fleet", ignore_errors=True)
    runs["train:sm"], sm_model = phase_train_cnn(
        torch, "sm", pipeline_config("sm", corpora["sm"]), cnn["sm"])
    runs["slice:sm"] = phase_slice_full(torch, sm_model, spacy_corpus[1], runs["slice:cnn"],
                                        phase="slice:sm", need=("hash_embed_gather_sum",),
                                        cpu_compare=True)
    shutil.rmtree(WORK / "train_sm", ignore_errors=True)
    # the text, span and token classifiers over the CNN trunk
    for name in ("spancat", "textcat", "tokcls"):
        runs[f"train:{name}"], model = phase_train_cnn(
            torch, name, pipeline_config(name, corpora[name]), cnn[name])
        runs[f"slice:{name}"] = phase_slice_cnn(torch, model, corpora[name][1],
                                                phase=f"slice:{name}")
        shutil.rmtree(WORK / f"train_{name}", ignore_errors=True)
    # spaCy's md layout: static vectors, the rule components, a NER with its own trunk
    runs["train:md"], md_model = phase_train_cnn(torch, "md", md_cfg(), cnn["md"])
    runs["slice:md"] = phase_slice_full(torch, md_model, spacy_corpus[1], runs["slice:cnn"],
                                        phase="slice:md", need=("hash_embed_gather_sum",),
                                        cpu_compare=True, ents_floor=0.99)
    # several models on one card: trf (pinned), md and cnn behind one manifest,
    # then cnn served live from a training run's checkpoints
    runs["serve:multimodel"] = phase_serve_multimodel(
        torch, full_model, md_model, md_model.parent / "last-model", cnn_model, spacy_corpus[1])
    # the serving fleet of train:cnn's model (two replica processes behind the
    # router, one SIGKILLed under load and restarted) comes up beside serve:watch
    fleet_serve = []
    try:
        runs["serve:watch"] = phase_serve_watch(
            torch, cnn_model, spacy_corpus, runs["train:cnn"]["step_ms_median_events"],
            beside=lambda: fleet_serve.append(start_serve_fleet(cnn_model)),
            keep=WORK / "fleet_gens")
    except BaseException:
        for run in fleet_serve:
            stop_serve_fleet(run)
        raise
    # an entity linker added to the trained md pipeline, every md component
    # sourced from its best-model and frozen, the NER annotating: its assets,
    # kernels and training run inside serve:fleet, while the fleet's replicas
    # idle and their latency windows empty before its rollout
    nel = {}

    def nel_train():
        t = time.perf_counter()
        nel["kb"], nel["corpus"], nel["counts"] = nel_assets(spacy_corpus, WORK / "nel")
        emit({"phase": "nel:assets", "seconds": time.perf_counter() - t, **nel["counts"],
              "dev_floor": nel["counts"]["prior_only_dev_nel_micro_f"] + NEL_OVER_PRIOR,
              "dev_floor_reported": DEV_FLOORS["nel"]["nel_micro_f"]})
        cfg = nel_config(nel["corpus"], md_model, nel["kb"])
        setup = cnn_setup(torch, {"nel": cfg}, trunk="entity_linker")
        leaves = "train:nel's: md's 60 (frozen: zero gradients) and the linker's"
        for name, rows in phase_cnn_kernels(torch, setup, leaf_sets=(("nel", leaves),)).items():
            kernels[name].extend(rows)
        STEP_CALLS.clear()
        # nel_assets' independent vectors: the 0.85 floor reported, not held
        runs["train:nel"], nel["model"] = phase_train_cnn(
            torch, "nel", nel_config(nel["corpus"], md_model, nel["kb"]), setup["nel"],
            grad_probe=nel_grad_probe, floors={})

    # the fleet rolls serve:watch's last generation out, and refuses one of
    # train:md's (another tree)
    runs["serve:fleet"] = phase_serve_fleet(
        torch, fleet_serve[0], spacy_corpus[1], smi,
        {"dir": WORK / "fleet_gens", "stamp": runs["serve:watch"]["generations"][-1],
         "mismatch": md_model.parent / "last-model"}, beside=nel_train)
    shutil.rmtree(WORK / "fleet_gens", ignore_errors=True)
    shutil.rmtree(WORK / "train_full", ignore_errors=True)
    shutil.rmtree(WORK / "train_cnn", ignore_errors=True)
    nel_corpus, nel_counts, nel_model = nel["corpus"], nel["counts"], nel["model"]
    runs["slice:nel"] = phase_slice_full(torch, nel_model, nel_corpus[1], runs["slice:md"],
                                         phase="slice:nel", need=("hash_embed_gather_sum",),
                                         cpu_compare=True, ents_floor=0.99)
    shutil.rmtree(WORK / "train_nel", ignore_errors=True)
    # the same seed and corpora over a KB whose vectors share a direction per
    # candidate number: the 0.85 floor held there
    shared_kb = nel_assets(spacy_corpus, WORK / "nel_shared", shared=True)[0]
    runs["train:nel_shared"] = train_nel_shared(
        torch, nel_config(nel_corpus, md_model, shared_kb),
        nel_counts["prior_only_dev_nel_micro_f"])
    shutil.rmtree(WORK / "nel", ignore_errors=True)
    shutil.rmtree(WORK / "nel_shared", ignore_errors=True)
    # a linker pipeline the JAX package wrote, with its own answers
    runs["slice:nel_jax"] = phase_slice_nel_jax(torch)
    # a trunk started from weights: cnn.cfg's trunk pretrained (characters,
    # then md's vectors), cnn.cfg trained from the pretrained trunk through
    # the CLI with --code and an augmenter, trf.cfg's trunk from a file in
    # RoBERTa-base's layout
    raw = write_raw_text(udgen[0])
    pt_cfgs = {"chars": pretrain_config(spacy_corpus, raw, "characters", PRETRAIN_STEPS),
               "vectors": pretrain_config(spacy_corpus, raw, "vectors", PRETRAIN_VECTOR_STEPS,
                                          vectors=md_in[0])}
    pt_leaves = {f"pretrain_{k}": pretrain_leaf_shapes(c) for k, c in pt_cfgs.items()}
    for name, rows in phase_cnn_kernels(
            torch, {**pt_leaves, "microbatches": {}, "zero_grad_leaves": {}},
            leaf_sets=(("pretrain_chars", "pretrain:chars: cnn.cfg's trunk + the characters "
                        "head (Maxout 300 x 3 pieces, Linear 2056)"),
                       ("pretrain_vectors", "pretrain:vectors: cnn.cfg's trunk + the vectors "
                        "head (Linear 300)"))).items():
        kernels[name].extend(rows)
    runs["pretrain:chars"], pretrained = phase_pretrain(torch, "chars", pt_cfgs["chars"],
                                                        PRETRAIN_STEPS)
    runs["pretrain:vectors"], _ = phase_pretrain(torch, "vectors", pt_cfgs["vectors"],
                                                 PRETRAIN_VECTOR_STEPS)
    runs["train:cnn_pretrained"] = phase_train_cnn_pretrained(torch, spacy_corpus, pretrained)
    for name in ("pretrain", "pretrain_chars", "pretrain_vectors"):
        shutil.rmtree(WORK / name, ignore_errors=True)
    runs["train:trf_init"] = phase_train_trf_init(torch)
    shutil.rmtree(WORK / "train_md", ignore_errors=True)
    shutil.rmtree(WORK / "md", ignore_errors=True)
    # a model directory the JAX package wrote (bin/make_jax_md_fixture.py), with
    # its vectors.npz and components.json, served on the card
    runs["slice:md_jax"] = phase_slice_cnn(torch, ROOT / "tests" / "data" / "jax_md",
                                           spacy_corpus[1], phase="slice:md_jax")
    # trf.cfg's trunk with 8 switch experts: trained through the CLI,
    # served, its telemetry read and its generations hot-swapped; then the
    # JAX-written MoE directory served
    runs["train:moe"], moe_out = phase_train_moe(torch, udgen, moe_shapes)
    runs.update(phase_slice_moe(torch, moe_out, udgen[1]))
    shutil.rmtree(WORK / "train_moe", ignore_errors=True)
    runs["slice:moe_jax"] = phase_slice_moe_jax(torch)
    shutil.rmtree(WORK / "udgen", ignore_errors=True)
    shutil.rmtree(WORK / "spacy_corpus", ignore_errors=True)
    shutil.rmtree(WORK / "head_corpora", ignore_errors=True)

    meta = {
        "hash_embed_gather_sum": ("spacy_ray_tpu_torch/csrc/hash_embed.cu",
                                  "spacy_ray_tpu/ops/pallas_kernels.py:59"),
        "flash_attention_fwd": ("spacy_ray_tpu_torch/csrc/flash_attention.cu",
                                "spacy_ray_tpu/ops/flash_attention.py:63"),
        "int8_weight_matmul": ("spacy_ray_tpu_torch/csrc/int8_matmul.cu",
                               "spacy_ray_tpu/ops/int8_matmul.py:148"),
        "hash_embed_table_grad": ("spacy_ray_tpu_torch/csrc/hash_embed_grad.cu",
                                  "spacy_ray_tpu/ops/pallas_kernels.py:40"),
        "flash_attention_bwd": ("spacy_ray_tpu_torch/csrc/flash_attention_bwd.cu",
                                "spacy_ray_tpu/ops/flash_attention.py:82"),
        "fused_update": ("spacy_ray_tpu_torch/csrc/fused_update.cu",
                         "spacy_ray_tpu/ops/fused_update.py:135"),
    }
    per_table = ("hash_embed_gather_sum", "hash_embed_table_grad")
    totals_for = {
        "serving": "one serving dispatch at B 8, T 128",
        "training": "one training microbatch at B 64, T 128",
    }
    line = []
    for name, (source, replaces) in meta.items():
        # one serving dispatch at B=8, T=128 (K1, K2, K4) or one training
        # microbatch at B=64, T=128 (K1 bwd, K3; one optimizer step for K5):
        # the shapes weighted by calls (K1 and its gradient: 1 NORM + 3 other
        # tables; K2, K3, K4: one layer's calls)
        dispatch = "training" if name in ("hash_embed_table_grad", "flash_attention_bwd",
                                          "fused_update") else "serving"
        rows = [r for r in kernels[name] if r["dispatch"] == dispatch]
        w = {id(r): (r["calls_per_dispatch"] if name in per_table else 1) for r in rows}

        def total(key):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(w[id(r)] * r[key] for r in rows)

        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(runs[p]["launches"][name] for p in runs),
            "max_abs_err": max(r["max_abs_err"] for r in kernels[name]),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": rows[0]["bound_by"], "library_ms": total("library_ms"),
            "totals_for": totals_for[dispatch] + (
                " (one optimizer step over trf.cfg's leaves)" if name == "fused_update" else ""),
            "shapes": kernels[name],
        })
    emit({"kernels": line})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
