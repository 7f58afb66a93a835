#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (evergreen_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile OUT_DIR | --sweep | --procs | --crash |
                           --matrices | --timed N [ROOT] | --fleet-crash N]

from the root of a checkout; it needs one card. Phases (any failure
raises and exits non-zero; 6 and 7 run after phase 9's profiled round,
beside the fleet process, see phase 10):

1. card and build: the card's name and power limit, then every kernel of
   the solve built from csrc/ (one nvcc per source, in parallel) and the
   snapshot's evgpack C packer (``evgpack_status()`` must be
   ``"native"``); the SM clock the chain bounds use, and the launch floor
   (the device time of a one-element ``add_``). The packer at config 3
   against its plain version runs in the scenario process before its gate
   (``packer_phase``: cold builds and a resident plane's cold rebuild
   and distro-set change byte-identical, both packers' ms);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the solve gives it on BASELINE config 3 (200 distros × 50k
   tasks × 4,000 hosts) and on ragged cases — ``segment_sum`` on each of
   its three plans at one and two columns, bit-equal to the CPU; then
   its device time, the plain version's, one PyTorch library call's
   (torch.profiler), the plan build's, and the bound: the larger of the
   byte, operation and (for ordered sums) chain bounds;
3. the main path at config 3 (seed 0, seed 0 with a capacity page,
   seed 1): ``run_solve_packed`` on the card, then the same three
   problems as requests to the solver sidecar
   (``serve_background(device="cuda")``) — each reply byte-identical to
   the library call, the integer outputs equal to the port's own CPU
   run, the f32 outputs within their tolerances, and each kernel
   launched exactly as often as the solves call it (in all, and per
   segment plan); then request and solve times and a profile of each
   solve (a chrome trace in OUT_DIR with ``--profile``);
4. stacked rounds: config 3, seed 0, split over four shards by
   ``build_sharded_snapshot`` (cold, and warm with memos: byte-identical),
   one shard with a 48-step capacity page, one with 24, two with none.
   ``StackedSolveCache().solve_blocks`` on the card, each block
   byte-identical to its shard's ``_packed_solve`` at the stack's 48
   steps, integer outputs equal to the CPU stack, and both kernels held
   against their plain versions on each block as in phase 2; then one
   round served by a ``SolverService`` on the card to four
   ``SolverClient``s in ``spawn`` worker processes (started before the
   backend probe, so that their imports overlap the probe and the build;
   phase 1 waits for them before its first profile), three more to them
   and three to clients in threads (seven each until phase 11 needed the
   time), every
   round and client "stacked", every block byte-identical to the
   in-process stack, each round launching 4 ``fused_distro_stats`` and
   4 × (5 + 48) ``segment_sum``; ``serve_round`` wall times, beside the
   in-process stack's and four sequential ``run_solve_packed`` (with
   ``--profile``, a profile of the in-process stack and its chrome trace;
   cut from the default run for phase 13: phase 9 profiles a stacked
   round);
5. the device mirror: config 3, seed 0, through a churn sequence (a cold
   sync, a tick's time refresh, scattered rows, a step whose sparse part
   covers over half of the f32 buffer, a change of layout), with the
   spans taken by diffing the host buffers; after each step the mirror
   is byte-identical to the host truth, the solve fed from it
   byte-identical to a fresh upload's and launching its kernels once,
   and the counters are as the spans predict; H2D bytes per step;
6. the tick's planning half from a store: config 3, seed 0, inserted
   into the port's ``Store`` with every distro opted into the capacity
   program (quota 5,400 mock hosts, fleet intent budget 500); the chain
   of the tick (intent budget, capacity page, ``build_snapshot``,
   ``_solve_bounded``, ``_unpack_solve``, the alias and single-task
   rules, ``CapacityPlane.apply``) on the card with ``fused="auto"``,
   then twice with ``fused="two_call"`` (once under a solve deadline),
   each run equal to the same chain on the CPU (every float exact but
   the capacity relaxation's ``fractional``), planned by the device
   solve with no fallback counter moving and its kernel launches exact;
   the fused and two-call runs give the same targets, and the two-call
   runs are byte-identical; then wall times of each step and of
   ``run_capacity_solve`` alone (its profile was cut for phase 13: phase
   3 profiles the same solve);
7. the whole tick from a store: config 3, seed 0, with phase 6's
   capacity settings, in a store for the card and one for the CPU;
   ``run_tick`` at a fixed ``now``, a churn of a few hundred tasks
   (dispatched, finished, new, re-prioritised), ``run_tick`` at
   ``now + 15``, then one tick with the solve breaker held open (a tick
   with a fault at ``scheduler.solve`` before it was cut when phase 13
   needed the time: ``PHASE7_TICKS``; phase 8's cold card store runs the
   solve fault). After each tick every document
   the tick writes (queues, secondary queues, tasks, hosts with the
   intents, events, shed records) equals the CPU's, as do the span
   documents (``span_json``: ids, times and threads masked), the
   ``TickResult`` counts and the persister's write shapes, and the
   tick's span tree is the cold tick's (``cold_tree_names``); the solve
   ticks are planned by the card with no degradation and launch exactly
   1 ``fused_distro_stats`` and 53 ``segment_sum`` each, the degraded
   tick falls back to the serial oracle and launches nothing.
   Intent ids and secrets (``uuid.uuid4``), intent creation times
   (``time.time``) and event ids are made the same for both stores;
   then the wall time of each phase of the two solve ticks, and the
   garbage collector's share of it. Each tick follows a full
   ``gc.collect()`` (a second run on fresh stores with the CPU's store
   ticked first was cut when phase 8's loop needed the time), under the
   interpreter's default collector (``untuned_gc``: phase 8 tunes it for
   the process);
8. the service's tick (``TickOptions(use_cache=True)``): config 3 in
   three stores (warm on the card, warm on the CPU, cold on the card),
   five ticks with churn, a solve fault, a distro-set change and a quiet
   tick (a second quiet tick with tracing off was cut for phase 13:
   tracing's cost runs untraced quiet ticks on the card after the
   loop), every document equal across the stores after
   each, the warm stores' span documents and each tick's span tree equal
   (the CPU publish's ``arena_lease`` aside), the cold store's tree a
   cold tick's (``service_phase``); then the loop (``service_loop``):
   an agent pass (``agent_pass``: finish every task in flight through
   ``mark_end``, pull for every free host through a
   ``DispatcherService``) and a tick (a second round was cut when phase
   13 needed the time), the (host, task) pairs and every
   document equal after each pass and tick (the cold store's queue
   infos in name order, ``infos_by_name``), the loop ticks' launches
   exact; the warm card store's first loop tick runs its solve under the
   device profiler (``TracerConfig.xla_profile_dir``): its Chrome trace
   names both kernels, their device time fits in the ``solve`` span, and
   the next tick into that directory writes no second trace; after
   tracing's cost (eight quiet ticks, ``tracing_cost``), a few pulls'
   ``dispatch_assign`` spans parent into the last tick's trace
   (``dispatch_parenting``);
9. the sharded plane: config 3 split by ``seed_partition`` over four
   shard stores on the one card, in three planes — (a) on the card with
   ``stacked="always"`` (every block of a round in one stacked solve),
   (b) on the card with ``stacked="auto"`` (local on one card: each
   shard ticks through its own resident plane and mirror), (c) on the
   CPU with ``stacked="never"`` — for four rounds: prime, churn, shard
   0 held at YELLOW so one affinity group migrates, and the round after
   the handoff, whose plane (a) ticks under torch.profiler (device busy
   time, idle share, the host's time in CUDA synchronisation; plane
   (b)'s profile was cut for phase 13). Two quiet
   rounds before the profiled one were cut to make room for phase 10,
   and the quiet round before the YELLOW one for phase 11. After each
   round every shard store's documents are equal across the planes
   (intent and event ids canonicalised: which shard's tick draws which
   id depends on thread order), the local planes' span documents equal
   (plane (a)'s, whose stacked rounds pack fresh, held by their tick
   count), no document has two owners, the migrations are equal, plane
   (a)'s mode is ``PLANE_A_MODES``'s (round 1 local, round 2 stacked or
   local where some shard's dims outgrew the floor, stacked from round
   3 on), and each plane launched the kernels once per block solved;
   then an agent pull for every free host through
   ``assign_next_available_task_fleet`` on planes (a) and (c), the
   pairs and documents equal (``fleet_pull``); then, without intents, a
   fresh plane (a)'s merged queues equal a single store's card tick, and
   a failed launch inside its stacked solve raises out of ``tick()``
   with no local solve;
10. the service's tick as ``units/crons.py`` runs it
   (``TickOptions(use_cache=True, async_persist=True,
   solve_deadline_s=10.0, tick_budget_s=12.0)``) on durable stores
   (``durable_phase``): config 3 less ``d199`` in (a) a ``DurableStore``
   on the card under a renewing ``FileLease``, (b) the same on the CPU,
   (c) the in-memory card store of phase 8; ticks prime and churn (a
   quiet tick after them was cut for phase 13), after each
   every document equal across the three (the span documents
   as ``span_json`` masks them), one
   WAL group frame a tick in (a) and (b) with equal records (span records
   masked, the CPU's ``arena_lease`` ones aside: ``canon_record``); then
   (a)'s directory copied without closing (a crash) and replayed, a
   churn tick on the copy on the card (a cold plane, a full mirror
   upload) and on (a), (b), (c): a replayed store's fresh persister
   rewrites the queue documents a live one skips, so the copy is held to
   the live stores without the queue documents' write stamps and the
   span attributes a fresh store records otherwise (``FRESH_ATTRS``); a
   thief takes (a)'s lease, (a)'s tick is ``"fenced"`` (no launch, no
   WAL byte, no document changed but the fenced tick's own root span in
   memory, the plane dropped); (b) checkpoints; and, in the fleet
   process beside phases 9, 6, 7 and 10 (``fleet_phases``, run by
   ``start_fleet_child``: it shares no store, directory or
   port with them; it starts before phase 8 and touches the card only
   after phase 8, which times a kernel, and phase 9's profiled round), a durable fleet
   (``ShardedScheduler.build(4, data_dir=..., stacked="always")`` on
   the card, its modes held to ``FLEET_MODES`` as phase 9 holds plane
   (a)'s) against an in-memory CPU plane, seeded in one group frame a
   shard, three rounds (prime; churn, stacked or grown past the floor; a
   quiet round that must stack), documents equal, each shard's tick
   spans counted equal, and a crash copy reopened by ``open_fleet`` on
   the card, its documents equal to the live fleet's. Cut to make room
   for later phases: the CPU copy reopened beside (a)'s, the torn frame, the thief's own open and tick,
   the fleet's YELLOW handoff and its round on the reopened fleet (for
   phase 13); the thief's and the reopened fleet's CPU twins (for phase
   11); a fleet round between the churn and the handoff (for phase 8's
   loop). Prints every tick's phases with ``wal_commit``, the frame
   writes, the barrier waits, WAL bytes, replay, checkpoint and
   ``open_fleet`` ms;
11. in the fleet process after phase 10's durable fleet, the
   process-per-shard fleet (``process_fleet_phase``): config 3
   seeded over four shard segments at epoch 0 (each shard a quarter of
   phase 6's quota and intent budget) with a churn written without a
   lease that each recovery step acts on (benchgen's phantom
   ``running_task`` claims, tasks in flight on hosts with stale
   heartbeats, gone or terminated, mock hosts building);
   ``FleetSupervisor(..., solver="always")`` on the card spawns four
   ``runtime/worker.py`` processes on it (lease, replay, recovery pass,
   hello at epoch 1) and leads their stacked solves; six rounds with the
   service's options: prime, two quiet rounds, ``migrate`` over the
   control protocol, the round after it, shard 2 drained and SIGKILLed,
   the watchdog's restart at epoch 2 (replay and recovery again), a
   round, ``agent_sim`` (each worker finishes its tasks in flight and
   dispatches every free host), a round, ``stop(graceful=True)``. This
   is not what ``service --shards 4`` runs on one card: its
   ``solver_leader`` ("auto") counts one device against four shards and
   elects no leader, so its workers solve locally. Checked: the epochs, each
   recovery's counts against a CPU twin (the same sequence in-process in
   a process of its own on a copy of the seeded directory), the modes
   (``PROC_MODES``), the leader's launches per stacked block and each
   worker's per local solve (its ``status`` counters, the killed worker's
   read before the kill), every shard's documents against the twin's
   (which replays the agent pass; span documents masked), each worker's
   ``dispatched`` and ``unfinished`` against the twin's, one
   ``fleet.round`` span a round on the supervisor's front store, one
   owner per document, every lease released; the front a ``service
   --shards`` process serves (a ``RestApi`` over the front store, the
   supervisor attached, on a socket): after each round ``GET
   /rest/v2/admin/fleet`` equals ``fleet_state()`` (its wall times
   masked) and ``GET /metrics`` parses, the solver plane's rounds counter
   and round-time histogram grown by exactly the round's serves and
   stacked serves (``fleet_reads``); prints the start, each recovery,
   each round and shard tick, the leader's serves, the takeover, the
   reads and the stop in ms;
12. the job plane and the REST agent surface (``cron_phase``): config 3
   with phase 6's capacity settings seeded once into a durable directory
   (every running host with a mock instance; one version with a parser
   project, ``CRON_PROJECT``, that echoes and, for every fourth task,
   exits 9, and ``CRON_IN_FLIGHT`` of its tasks dispatched) and copied;
   ``Environment.build(data_dir=..., workers=1)`` on (a) the card, with
   ``require_auth=True``, and (b) the CPU (lease, replay, migrations, the
   recovery pass; on the card the kernels' build before the job plane
   starts; the build does not probe: phase 1 probed, and phase 13's
   service process probes in ``main``), their migration results and
   recovery reports equal; (a)'s ``env.api`` served on a socket. Four cron rounds
   (``cron_runner.tick(force=True)``, ``queue.wait_idle``; the clock of
   ``CRON_ROUND_AT``), fed by the ingestion plane: before round 2 the
   project of a large monorepo (``ingest_project``: a variant on each of
   the 200 distros, 50 task definitions each, 10,001 tasks a version) is
   put and one revision of it pushed (``ingest_push``: over HTTP with the
   API user's key on (a), through the same handler in process on (b));
   before round 3 a revision source with one new commit (its project
   adds a 2 × 2 matrix) is registered, a narrowed patch posted with
   ``finalize`` and a merge group enqueued (``ingest_more``); after rounds 2-4 ``ingest_checks`` holds what the
   card's tick queued (the pushed version's waiting tasks, the patch's
   rows, the merge group's merge counts from ``fused_distro_stats``, the
   ``generate-tasks`` job's tasks, the ``repotracker`` job's version, the
   ``activation-catchup`` job's batchtime builds). After round 2 the agent
   pass: on (a) over HTTP (``RestCommunicator`` with
   each host's ``Host-Id``/``Host-Secret``, the secrets minted by the
   migration), on (b) through ``LocalCommunicator``, one request at a
   time (``comm_pass``): every task in flight (with the pushed version's
   generator, dispatched to a free host of its distro before the pass:
   ``ingest_generator``), in id order, fetches its
   config, starts, runs its commands (``Agent._run_task``: the heartbeat
   before each command, the logs posted) and ends with its outcome, then
   every free host pulls in id order; the finished tasks, the (host,
   task) pairs and every document equal, the generator's payload
   staged (the first ``PASS_PULLS`` free hosts pull: 2,048 since PR
   15, 1,024 since PR 25). Before round ``ADMIN_ROUND``'s ticks the
   admin round (``admin_sequence``), through both environments'
   ``RestApi.handle`` with the superuser's key: the pushed version
   aborted and restarted, a distro with queued tasks refused while its
   hosts live, drained and deleted, ``set_admin`` of the capacity
   budget and a task limit, an annotation, the reliability of the seeded
   project, the pushed project copied with its variables, every answer
   (a) = (b); after the round's ticks (``admin_checks``) the card's tick
   planned one distro fewer, no queue holds the deleted distro or its
   tasks, the card plane's snapshot equals a cold build of the same
   gather and its mirror the host truth, the capacity fleet (a) = (b)
   within the new budget. Beside it, before the same ticks, the GraphQL
   round (``gql_sequence``, ``POST /graphql`` through both
   environments' ``RestApi.handle`` with the superuser's key):
   ``setTaskPriority`` on the last ``GQL_RAISED`` queued tasks of the
   longest queue, ``unscheduleTask`` on its first, ``scheduleTasks`` on
   tasks the abort deactivated, ``copyDistro`` of that distro (the set
   grows back past the delete), ``saveAdminSettings`` of the banner,
   then ``taskQueue``, ``distroTaskQueue``, ``taskQueueDistros``,
   ``version``, ``versionTasks``, ``waterfall`` and ``spruceConfig``
   served by each follower; every answer (a) = (b) and none an error;
   after the ticks (``gql_checks``) the raised tasks lead the queue the
   card wrote, the unscheduled one is gone, the copy is planned with no
   degradation, the resident planes' rebuilds (a) = (b), and (a)'s queue
   documents equal those of a cold tick on the card of a copy of (a)'s
   store taken before the round's ticks (``store_copy``); then every
   document the page embeds (``page_round``, on the entities its test
   seeds, ``page_world``) answers without an error, (a) = (b). Each
   environment runs on its
   own uuid4 stream, event sequence, mock cloud table and log sink, on
   one pinned clock (the REST handlers read it too), the overload
   ladder's disk- and clock-fed rungs and its request-rate rung off
   (``CRON_OVERLOAD``).
   After each round every document of (a) equals (b)'s
   (``same_cron_docs``: the span masks, the system sample's resource
   readings, the log records' wall-clock readings), no job failed,
   ``host-create`` spawned what ``host_throttle`` allows (32) and
   provisioned them, the same hosts in (a) and (b), the tick job planned
   by the card with no degradation or fallback counter moving, launches
   exact. After each round the read path (``read_round``): a GET of
   every route of ``api/readcache.py::_ROUTES`` (``READ_DISTROS``
   distros' queues) through both environments' ``RestApi.handle`` in
   process, with the API user's key, conditional on the ETag the
   previous round's read got, then a plain GET after each 200; the
   statuses and payloads equal across (a) and (b), a queue route 304
   exactly when the persister's fingerprint version and the queue
   document's stamps held and its 200 the tick's document, the cache
   counters moved by the 304s and cache hits, and no kernel launched.
   The event plane: egress on in both, every HTTP channel aimed
   at a local sink (``LocalSink``; email stays in its outbox), a
   subscription of each channel seeded before round 1
   (``seed_event_plane``); the ``event-notifier`` and ``outbox-drain``
   jobs run in every round, the notifications and outbox rows equal
   with every document, the sink's deliveries in each round equal
   between (a) and (b) and each webhook's ``X-Evergreen-Signature`` its
   body's HMAC; ``/metrics`` over HTTP moved by the round's two ticks and
   no failed delivery; each environment's notification sequence and
   senders swapped like its event sequence. After the reads the
   operator's routes (``operator_round``): provenance and capacity of
   ``READ_DISTROS`` distros within ``ROUTE_RTOL``, the last tick's span
   tree, traces, ladder, stats, spans, log lines and events equal across
   (a) and (b), ``api_requests_total`` moved by exactly the requests, no
   launch; the notifier's and the drain's ms printed a round.
   Then a round of (a) with the default pool
   (``AmboyConfig.pool_size_local``, 8 workers) and the default ladder:
   each admitted job ran once, the shed ones are recorded and counted,
   no two jobs holding a scope overlapped, launches exact; it prints the
   ladder's levels and each populator's deferrals. During that round a
   burst of ``BURST_THREADS`` agent threads runs ``Agent.run_once`` over
   HTTP for the first ``BURST_HOSTS`` free hosts (pulls that may park, tasks run to their
   end), and the pass and the burst print pulls a second and each route
   class's request ms (p50 / p99, ``timed_routes``). Then a failed
   launch inside the tick job: ``wait_idle`` raises the ``KernelError``,
   the runner's next tick raises it again and enqueues nothing, the job
   type is not counted toward quarantine. Both environments close and
   release their leases. Prints the build's split (lease, open and
   replay, migrations, recovery, kernels), each round's wall and each
   job type's run ms (its ``job.run`` spans), the tick job's wall beside
   phase 10's quiet durable tick, and ``host-create`` for 32 hosts;
13. the entry points (``entry_phase``): ``python -m evergreen_tpu_torch
   service --data-dir D --port 0 --workers 1 --require-auth`` on the card,
   started during phase 12 (``EntryService``, so that its boot overlaps
   phase 12) on phase 12's seeded documents written to a directory of its
   own, moved to the wall clock, its running hosts static machines
   (``prepare_entry_dir``);
   once it listens, ``python -m evergreen_tpu_torch patch --finalize``
   with the API user's key posts a small project's patch on the agents'
   distro (``entry_patch_text``: ``compile`` packs a tarball, puts it in
   the agents' shared bucket and attaches its path; ``unit-tests`` gets
   and unpacks it and attaches a results file and an xunit file;
   ``lint`` saves and restores a cache), which the service's cron plane
   plans on the card;
   the service takes ``--github-webhook-secret``, and a push hook signed
   with it (``entry_hook_planned``: a small project on the agents'
   distro, its file read from a local stand-in for the GitHub contents
   API) makes a version whose tasks the card's tick queues, while one
   signed otherwise answers 401;
   ``ENTRY_AGENTS`` ``python -m evergreen_tpu_torch agent --once``
   processes with their hosts' credentials pull from it and run what they
   are handed, the patch's tasks among them; after the user's loop
   (``entry_operator``) a subscription made over REST is listed, deleted
   and gone through ``subscriptions`` processes (no ``torch``), and
   ``/metrics`` and ``/healthz/ready`` answer; after the agents
   (``entry_admin``) ``version`` and ``admin set-flag`` processes
   (no ``torch``) aimed at the replica: a user without the superuser
   scope gets the 403 answer, and 403 to its read of the settings, the superuser's write of
   ``service_flags.ENTRY_FLAG`` is forwarded and read back on the replica
   and the service, whose next tick reads it (``entry_admin_read``: a
   tick without the capacity phase on its ``/metrics``); GraphQL with the
   API user's key (``entry_graphql_write``, ``entry_graphql``): a query the
   service's follower answers (``extensions.served_by``), a
   ``setTaskPriority`` that the service's next tick plans, a query the
   replica answers from its own tail and a mutation it forwards and reads
   back, the viewer's ``adminSettings`` refused with the JAX package's
   error, and ``GET /`` serving the page; SIGTERM. Held: the patch
   process imported no ``torch``, every patch task ends ``success``
   (``GET /rest/v2/tasks/{id}``) and the patch is started with its
   version (``GET /rest/v2/patches/{id}``); then a user's loop
   (``entry_user_loop``): a ``login`` process prints a session token,
   with which alone the tests route lists ``unit-tests``' results in
   attach order, the artifacts route ``compile``'s files and the status
   answers 200; a ``fetch --artifacts`` process copies the file at the
   attached path; ``POST /logout`` makes the token 401; each agent completed a task
   and imported no ``torch`` and no probe (``-X importtime``), the
   service exited 0
   and released its writer lease, the reopened directory holds the
   agents' ends, every tick the service ran planned on the card with no
   degradation, and the launches its drain line prints are exactly those
   of that many solves, the ticks after the flag without the capacity
   page. Beside phases 12 and 13, ``python -m evergreen_tpu_torch smoke``
   runs as a process of its own on its own in-memory store and port
   (``start_smoke``, ``join_smoke``): exit 0, ``SMOKE OK``, the sample
   project's three tasks succeeded, ``graphql agrees: success``, on
   ``cuda``, and its launch line exact for its solves. The service runs
   with ``--capture-trace``; once it has drained, ``python -m
   evergreen_tpu_torch replay-trace <its file> --no-run --out <spec>``
   exits 0 and the spec's tick-0 fleet holds the agents' distro (a
   compile only: its store is config 3); beside phase 13, ``replay-trace
   <the scenario process's region-failover trace>`` on the card exits 0,
   ``ok`` and ``deterministic``, its launch line exact for the device
   solves it prints. The scenario process (``start_scenario_child``,
   started with the fleet process and gated with it; its own temporary
   directories under ``SCENARIO_ROOT``, in the system's temp dir) solves
   once at a weather's
   dims, then on the card: (1) the 13 library weathers, the 2 checked-in
   regression specs and the 9 fault and overload matrix cases, each
   twice on the card and once on the CPU: every entry ok, the card's
   two fingerprints equal and equal to the CPU's, and the 20
   deterministic specs ``SCORECARD_GREEN.json`` names equal to that
   file's fingerprints (the timed ``overload-slow-store-storm``, whose
   ladder reads the WAL's real commit latency, runs last, once phase 13
   has ended, ``timed_round``, held by its checks, invariants and
   SLOs); (2) ``FUZZ_SEEDS`` generated weathers
   from ``FUZZCARD_GREEN.json``'s start seed the same way, and the
   engine's sabotage self-test; (3) ``config3-failover``
   (``config3_failover_spec``: config 3 on a durable store, a
   torn frame at tick 1's commit, a lease stolen at tick 3,
   ``FAILOVER_TICKS`` ticks, the tick pipeline without the service loop)
   on the card and on the CPU: both ok with
   ``resume_equals_rerun``, one fingerprint; (4) ``region-failover``
   under a ``TraceRecorder``, compiled from its events and from its data
   directory, each replayed twice on the card, ok and deterministic.
   Every card run's launches are held exact against the solves its
   ticks ran on the device (``SolveLog``: each solve's capacity trip
   count; a solve abandoned at its deadline runs on). Then, once the
   fleet process's phase 11 has run its prime round (its cold solves
   hold a 10 s deadline: step 5's worker processes do not boot beside
   them), (5) the process backend (``procs_round``): the proc weathers of
   ``PROC_CARD_WEATHERS`` through ``ProcScenarioRun`` on the card, each
   once, ok and converged to a CPU run of its workload's uninterrupted
   reference fleet (the solver-leader weathers' stacked solves on the
   card against the CPU's), the crash-matrix kill point
   ``PROC_CRASH_POINT`` against the CPU's reference, the network-chaos
   matrix's point ``PROC_NET_POINT`` (a solver return delayed past the
   workers' solve timeout: exactly that round degrades to local solves,
   the late result is fenced, a later round is fully stacked; converged
   to the CPU's reference of its workload) and, with ``PROC_SELFTEST``,
   the proc sabotage self-test equal to its CPU twin; the leader's
   launches held exact
   against the stacked blocks it solved, each worker life's last
   reported counters against the card solves it reported (``ProcLog``,
   ``proc_card_launches``). The crash process (``start_crash_child``,
   started with the scenario process, its gate opened once the fleet
   process has ended, joined once phase 13 has ended and before the
   timed case) runs the crash matrix
   (``evergreen_tpu_torch/scenarios/crash_matrix.py``, every child
   process under the lock-order witness): a CPU child's uninterrupted
   run of the single-store and of the 2-shard workload before its gate,
   then on the card (``crash_round``) the kill points
   ``CRASH_CARD_POINTS`` (each child killed at its seam, restarted,
   converged to the CPU's state, epochs [1, 2], invariants held), the
   two-process failover (the SIGCONTed holder fenced, no
   superseded-epoch frame past the fence point) and the handoff point
   ``CRASH_SHARDED_POINT`` on a 2-shard plane; each child life's
   launches exact for the card solves it reported (``crash_lives``);
   then the matrices round (``matrices_round``; its CPU side before the
   gate, in the crash process itself): the fault, overload and disk
   matrices (``scenarios/fault_matrix.py``, ``overload_matrix.py``,
   ``disk_matrix.py``), each a ``python -m`` child under the witness:
   ``MATRIX_FAULT_CASE`` (the async WAL's deferred error: degraded "",
   persist-failed, "") and, at the same time, the engine points
   ``DISK_CARD_POINTS``, each against its CPU run, and the disk grid's
   ``DISK_GRID_CONFIG`` points on the card machine's filesystem; then
   ``MATRIX_OVERLOAD_CASE`` alone (planning ticks on the card from the
   job queue's threads); every tick planned on the card, every child's
   launches exact, no inversion; and the net round (``net_round``; its
   CPU side before the gate, in the crash process; its child beside the
   fault and disk children): the network-chaos
   matrix (``scenarios/net_matrix.py``) as a ``python -m`` child under
   the witness, ``--grid-only --config classic``: its sabotage red with
   the CPU's verdicts, its 11 classic points ok with the CPU's verdicts
   and fingerprints, every tick planned on the card, launches exact, no
   inversion;
14. a JSON line of the kernels (launches: phases 7–13, by path, phase
   8's loop as the path "loop", phase 10's in-memory control store as
   "durable control", phase 12's card environment as "cron" (round 1)
   and "ingest" (the ticks after the push) and its cold tick as "cold",
   phase 13's service process as "rest", the smoke process as "smoke",
   the scenario process and phase 13's replay process as "scenarios",
   the scenario process's proc replays (step 5) as "procs", the crash
   process's children as "crash", its matrices round's as "matrices",
   its net round's as "net";
   the other phases check theirs
   on lines of their own), the card's line, and the last line
   ``{"ok": true, "device": {...}}``.

Before phase 1 the backend probe (``utils/torchenv.py``) must find the
card from a fresh interpreter.

``--sweep`` runs phase 1, then, instead of the rest, times both kernels
built with other values of their design constants (``sweep``) and
prints the card's line. ``--procs`` runs phase 1, then, instead of the
rest, step 5 of the scenario process alone with every candidate of
``PROC_TIMING_WEATHERS`` and the proc self-test (``procs_timing``): the
walls a slice reads to choose ``PROC_CARD_WEATHERS``. ``--crash`` runs
phase 1, then the crash round alone (``crash_alone``). ``--matrices``
runs phase 1, then the matrices round alone (``matrices_alone``), each
wall printed; ``--net`` phase 1, then the net round alone (``net_alone``). ``--timed N
[ROOT]`` runs phase 1, then the timed case's round N times, its data
under ROOT (default: the system's temp dir), every healthy commit split
(``timed_rounds``, ``CommitSplit``): all N rounds must pass; the
healthy commits' p99 is printed against ``TIMED_P99_MS``.
``--fleet-crash N`` runs phase 1, then phase 10's durable fleet N
times with the crash round beside it (``fleet_crash``).

Imports only the port, torch, numpy and the standard library.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM: HBM rate and the f32 rate outside the tensor cores
#: (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: cycles from one dependent f32 add to the next on an SM; an ordered
#: sum of L elements takes at least L of them
FADD_CYCLES = 4

SEED = 0
CONFIG3 = (200, 50_000)
#: shards of the stacked rounds, their capacity pages (steps; 0 = none)
#: and the rounds served to the worker processes after the first and to
#: clients in threads (three since phase 11 came: seven before)
SHARDS = 4
SHARD_PAGES = (48, 24, 0, 0)
THREAD_ROUNDS = 3
ROUND_TIMEOUT_S = 90.0
#: how long phase 4's worker processes wait for their snapshot, handed
#: over when phase 4 begins (phases 1-3 take about half a minute)
WORKER_WAIT_S = 600.0
SUM_RTOL = 1e-5
#: the capacity relaxation (Newton steps with pow and division) and the
#: affinity block are the only f32 outputs the card may round otherwise
#: than the CPU; every duration sum is added in element order on both
CAP_TOL = dict(rtol=1e-5, atol=1e-6)
F32_TOL = {"cap_x": CAP_TOL, "aff_pool": CAP_TOL}

#: ``--sweep``: builds of each kernel with other values of its design
#: constants, the source's own values first. segment_sum's staging holds
#: a piece and one window past it (piece + threads elements) in one
#: round of threads × stage-unroll gathers and in a quarter of its tile
#: (the source's static_assert), which leaves out larger pieces.
DS_VARIANTS = [dict(DISTRO_STATS_THREADS=t, DISTRO_STATS_UNROLL=u)
               for t, u in ((64, 8), (32, 8), (128, 8), (256, 8), (64, 4), (64, 16))]
SS_VARIANTS = [dict(SEGMENT_SUM_THREADS=t, SEGMENT_SUM_PIECE=p,
                    SEGMENT_SUM_STAGE_UNROLL=u, SEGMENT_SUM_WALK_DEPTH=w)
               for t, p, u, w in (
                   (256, 512, 3, 2), (256, 512, 4, 4), (256, 1024, 8, 4), (256, 512, 8, 4),
                   (256, 1536, 8, 4), (256, 1024, 16, 4), (128, 512, 8, 4), (128, 1024, 16, 4),
                   (256, 1024, 8, 1), (256, 1024, 8, 2), (256, 1024, 8, 8), (256, 512, 3, 4),
                   (256, 768, 4, 4), (256, 256, 2, 4), (256, 256, 4, 4), (128, 256, 4, 4),
                   (128, 384, 4, 4), (256, 512, 4, 2), (256, 512, 4, 8), (256, 256, 2, 2),
                   (256, 768, 4, 2), (256, 1024, 5, 4), (256, 1280, 6, 4), (256, 512, 3, 1))]


_T0 = time.perf_counter()
#: what the fleet process (``fleet_child``) puts before each of its lines
_TAG = ""
#: the interpreter's collector thresholds, before phase 8 tunes them
_GC_THRESHOLDS = __import__("gc").get_threshold()


def log(msg: str) -> None:
    """One line of the run's log, after the wall seconds since the
    script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {_TAG}{msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_cuda(torch, fn, reps: int = 21, inner: int = 20) -> float:
    """Median ms of one call of ``fn`` on the card: ``inner`` calls back to
    back between two CUDA events, ``reps`` times."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 50) -> float:
    """Device time of one call of ``fn``: the summed durations of every
    kernel, copy and memset it puts on the card, from torch.profiler over
    ``calls`` calls, divided by ``calls``. Host time between launches is
    not counted (``time_cuda`` counts it). A profile that sees no device
    work at all (it happened once in a sweep's long run of profiles) is
    taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / calls / 1e3
    raise AssertionError("the profiler saw no device time")


def measure(torch, kernel, plain, library) -> dict:
    """Device ms per call of the kernel's wrapper, its plain version and
    the library call, plus the wrapper's ms per call back to back."""
    return dict(
        ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
        library_ms=device_ms(torch, library), call_ms=time_cuda(torch, kernel),
    )


def bounds(bytes_: int, ops: int, chain_ms) -> dict:
    """The least time of the work: bytes over the HBM rate, operations
    over the f32 rate and, where the function's adds must form one ordered
    chain, ``chain_ms``; ``bound_ms`` is the largest, ``bound_by`` names it."""
    cands = {"bytes": 1e3 * bytes_ / HBM_BYTES_PER_S,
             "operations": 1e3 * ops / F32_OPS_PER_S}
    if chain_ms is not None:
        cands["chain"] = chain_ms
    by = max(cands, key=cands.get)
    return dict(bound_ms=cands[by], bound_by=by, byte_bound_ms=cands["bytes"],
                chain_bound_ms=chain_ms)


def fmt_row(r: dict) -> str:
    chain = ("none" if r["chain_bound_ms"] is None
             else f"{r['chain_bound_ms'] * 1e3:.3f} us")
    return (f"device time per call {r['ms'] * 1e3:.2f} us kernel, "
            f"{r['plain_ms'] * 1e3:.2f} us plain, {r['library_ms'] * 1e3:.2f} us "
            f"library; bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}; "
            f"bytes {r['byte_bound_ms'] * 1e3:.3f} us, chain {chain}); kernel "
            f"calls back to back {r['call_ms'] * 1e3:.2f} us each (host included)")


def ragged_cases(np):
    """Distro sizes that land on and around 1024-task tile edges and the
    kernel's warp and stride edges, empty distros, random sizes, and one
    distro owning 3·1024+17 tasks."""
    rng = np.random.default_rng(99)
    counts = np.array([0, 1, 31, 32, 33, 250, 257, 3 * 1024 + 17, 0])
    n = int(counts.sum())
    cases = [(counts, dict(
        t_valid=rng.random(n) < 0.9, t_deps_met=rng.random(n) < 0.7,
        t_expected_s=(rng.random(n) * 100).astype(np.float32),
        t_wait_dep_met_s=(rng.random(n) * 100).astype(np.float32),
        t_is_merge=rng.random(n) < 0.1,
    ), (rng.random(len(counts)) * 50 + 1).astype(np.float32))]
    for seed in range(6):
        rng = np.random.default_rng(seed)
        D = int(rng.integers(1, 40))
        counts = rng.choice(
            [0, 1, 7, 1023, 1024, 1025, int(rng.integers(0, 4000))], D
        )
        n = max(int(counts.sum()), 1)
        cases.append((counts, dict(
            t_valid=rng.random(n) < 0.9, t_deps_met=rng.random(n) < 0.7,
            t_expected_s=(rng.random(n) * 100).astype(np.float32),
            t_wait_dep_met_s=(rng.random(n) * 100).astype(np.float32),
            t_is_merge=rng.random(n) < 0.1,
        ), (rng.random(D) * 50 + 1).astype(np.float32)))
    n = 3 * 1024 + 17
    cases.append((np.array([n]), dict(
        t_valid=np.ones(n, bool), t_deps_met=np.ones(n, bool),
        t_expected_s=np.full(n, 2.0, np.float32),
        t_wait_dep_met_s=np.full(n, 2.0, np.float32),
        t_is_merge=np.zeros(n, bool),
    ), np.array([1.0], np.float32)))
    return cases


def profile_solve(torch, solve_once, out_dir) -> None:
    """One solve under torch.profiler: device time per kernel name and the
    summed device time against the profiled wall time; a chrome trace
    goes to ``out_dir`` when one is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    log(f"  profile: {launches} device ops, {busy / 1e3:.2f} ms device time in "
        f"{wall_us / 1e3:.2f} ms profiled wall ({100 * busy / wall_us:.1f}% busy)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    ours = [kv for kv in ranked if "distro_stats" in kv[0] or "segment_sum" in kv[0]]
    for name, (n, us) in ranked[:8] + ours:
        log(f"  {us / 1e3:8.3f} ms  {n:5d}x  {name[:100]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "solve_trace.json"))


def segment_inputs(torch, np, a, d_thresh) -> dict:
    """``segment_sum``'s inputs on the solve's three plans (task→segment,
    host→segment, distro→pool) over the unpacked snapshot ``a``: name ->
    (segment ids, segments, live mask, [2, n_elem] columns, the column
    count the solve sums there at once). The task plan takes the
    allocator's two duration columns, the others seeded random values on
    their live elements."""
    rng = np.random.default_rng(1)

    def masked_rand(live, scale):
        x = torch.as_tensor((rng.random(live.shape[0]) * scale).astype(np.float32))
        return torch.where(live, x.to(live.device), 0.0)

    dm = a["t_valid"] & a["t_deps_met"]
    dur = a["t_expected_s"]
    over = dm & (dur > d_thresh[a["t_distro"].long()])
    G = a["g_distro"].shape[0]
    return {
        "task": (a["t_seg"], G, a["t_valid"],
                 torch.stack([torch.where(dm, dur, 0.0), torch.where(over, dur, 0.0)]), 2),
        "host": (a["h_seg"], G, a["h_valid"],
                 torch.stack([masked_rand(a["h_valid"], 1.0),
                              masked_rand(a["h_valid"], 1.0)]), 1),
        "pool": (a["d_pool"], 8, a["d_valid"],
                 torch.stack([masked_rand(a["d_valid"], 100.0),
                              masked_rand(a["d_valid"], 10.0)]), 2),
    }


def hold_distro_stats(torch, args) -> float:
    """``fused_distro_stats`` on card tensors ``args``: bit-equal to its
    plain version on the CPU (counts, and both duration sums: the kernel
    adds them in element order, as ``index_add_`` does there) and to a
    second launch; against the plain version on the card, whose
    ``index_add_`` adds with atomics in no fixed order, counts exact and
    sums within ``SUM_RTOL``. Returns the max abs error against the
    latter."""
    from evergreen_tpu_torch.ops.distro_stats import (
        STAT_NAMES, STAT_SUMS, fused_distro_stats, fused_distro_stats_plain,
    )

    got = fused_distro_stats(*args)
    torch.cuda.synchronize()
    cpu = fused_distro_stats_plain(*(x.cpu() for x in args))
    on_card = fused_distro_stats_plain(*args)
    err = 0.0
    for name in STAT_NAMES:
        g, w = got[name], on_card[name]
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        check(torch.equal(g.cpu(), cpu[name]),
              f"fused_distro_stats {name} differs from plain on the CPU")
        if name in STAT_SUMS:
            torch.testing.assert_close(g, w, rtol=SUM_RTOL, atol=0.0)
        else:
            check(torch.equal(g, w), f"fused_distro_stats {name} differs from plain")
    again = fused_distro_stats(*args)
    for name in STAT_NAMES:
        check(torch.equal(got[name], again[name]), f"{name} not repeatable")
    return err


def hold_segment_sum(torch, pname, seg, n_seg, live, x2):
    """``segment_sum`` on plan ``pname`` at one and two columns against its
    plain version (rtol ``SUM_RTOL``, atol 1e-6), the CPU's order (bit for
    bit) and a second launch; returns the plan and the max abs error."""
    from evergreen_tpu_torch.ops.segment import (
        segment_plan, segment_sum, segment_sum_plain,
    )

    plan = segment_plan(seg, n_seg, live, name=pname)
    cpu_plan = segment_plan(plan.seg.cpu(), n_seg)
    err = 0.0
    for x in (x2[0], x2):
        got = segment_sum(x, plan)
        torch.cuda.synchronize()
        want = segment_sum_plain(x, plan)
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=1e-6)
        check(torch.equal(got.cpu(), segment_sum(x.cpu(), cpu_plan)),
              f"segment_sum[{pname}] differs from the CPU's order")
        check(torch.equal(got, segment_sum(x, plan)),
              f"segment_sum[{pname}] not repeatable")
        err = max(err, float((got - want).abs().max()))
    return plan, err


def sweep(torch, ds_args, plan_inputs) -> None:
    """Both kernels built with other values of their design constants
    (``DS_VARIANTS``, ``SS_VARIANTS``; the first of each is the source's
    own), each result held against the source's own build
    bit for bit, then timed at the config-3 shapes: device
    time per call in two rounds, the second in the reverse order."""
    import ctypes
    import re

    from evergreen_tpu_torch.ops import _build, distro_stats, segment

    jobs = ([("distro_stats", d) for d in DS_VARIANTS]
            + [("segment_sum", d) for d in SS_VARIANTS])
    t0 = time.perf_counter()
    paths = _build.build_variants(jobs)
    log(f"sweep: {len(jobs)} builds in {time.perf_counter() - t0:.2f} s wall")
    fns, notes = [], []
    for (name, defs), path in zip(jobs, paths):
        mod = distro_stats if name == "distro_stats" else segment
        fns.append(mod.bind(ctypes.CDLL(path)))
        with open(path[:-3] + ".log") as f:
            text = f.read()
        regs = "/".join(re.findall(r"Used (\d+) registers", text))
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
        notes.append(f"registers {regs}, spill stores {spills} B")

    def label(defs):
        return " ".join(f"{k.split('_', 2)[-1].lower()}={v}" for k, v in defs.items())

    def rounds(cases):  # label -> fn; two rounds of device_ms, in turn
        times = {lab: [] for lab in cases}
        for order in (list(cases), list(cases)[::-1]):
            for lab in order:
                times[lab].append(device_ms(torch, cases[lab]))
        return times

    n_ds = len(DS_VARIANTS)
    want = distro_stats.launch(*ds_args, fn=fns[0])
    cases = {}
    for defs, fn in zip(DS_VARIANTS, fns[:n_ds]):
        got = distro_stats.launch(*ds_args, fn=fn)
        check(all(torch.equal(got[s_], want[s_]) for s_ in got),
              f"fused_distro_stats {label(defs)}: not bit-equal")
        cases[label(defs)] = lambda fn=fn: distro_stats.launch(*ds_args, fn=fn)
    times = rounds(cases)
    for (lab, ts), note in zip(times.items(), notes[:n_ds]):
        log(f"sweep fused_distro_stats {lab}: "
            + ", ".join(f"{t * 1e3:.3f}" for t in ts) + f" us device time; {note}")

    for pname, (seg, n_seg, live, x2, _) in plan_inputs.items():
        plan = segment.segment_plan(seg, n_seg, live)
        for k, x in ((1, x2[0]), (2, x2)):
            want = segment.launch(x, plan, fn=fns[n_ds])
            cases = {}
            for defs, fn in zip(SS_VARIANTS, fns[n_ds:]):
                check(torch.equal(segment.launch(x, plan, fn=fn), want),
                      f"segment_sum[{pname}] {label(defs)}: not bit-equal")
                cases[label(defs)] = lambda fn=fn, x=x: segment.launch(x, plan, fn=fn)
            times = rounds(cases)
            for (lab, ts), note in zip(times.items(), notes[n_ds:]):
                log(f"sweep segment_sum[{pname}] k={k} {lab}: "
                    + ", ".join(f"{t * 1e3:.3f}" for t in ts)
                    + f" us device time; {note}")
    log("sweep: every build equal to the source's own")


def reset_launches(*kernels) -> None:
    for k in kernels:
        k.launches = 0
        if hasattr(k, "launches_by_plan"):
            k.launches_by_plan.clear()


def read_launches(fds, ss) -> dict:
    out = {"fused_distro_stats": fds.launches, "segment_sum": ss.launches}
    out.update({f"segment_sum[{p}]": c for p, c in ss.launches_by_plan.items()})
    return out


def expected_launches(iters) -> dict:
    """Launches of solves at capacity trip counts ``iters``: one
    fused_distro_stats each; segment_sum once on the task plan (both
    duration columns), once on the host plan, and on the pool plan once
    for the minimum mass, once per projection (the warm start and each
    Newton step) and once for the affinity's pool totals."""
    return {
        "fused_distro_stats": len(iters),
        "segment_sum": sum(5 + c for c in iters),
        "segment_sum[task]": len(iters),
        "segment_sum[host]": len(iters),
        "segment_sum[pool]": sum(3 + c for c in iters),
    }


def digest(out: dict) -> str:
    """One shard's named outputs as a SHA-256 over names, dtypes and bytes."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(out):
        h.update(name.encode() + str(out[name].dtype).encode())
        h.update(out[name].tobytes())
    return h.hexdigest()


def worker_loop(here, data_dir, shard, cmds, replies):
    """One shard's worker process: say it is ready once its imports are
    done (the process starts before the backend probe, so that they
    overlap the probe and the build), take its shard's snapshot off
    ``cmds`` (None before it ends the process), register its
    segment in the fleet manifest, then for each (epoch, seq, timeout) on
    ``cmds`` publish through ``SolverClient`` and wait for the leader's
    block, replying with the outcome and the block's digest; None ends
    it. It never touches the card: a fallback would solve on the CPU and
    report "local"."""
    sys.path.insert(0, here)
    from evergreen_tpu_torch.runtime import manifest
    from evergreen_tpu_torch.runtime.solver import SolverClient

    replies.put(("ready", shard))
    snap = cmds.get(timeout=WORKER_WAIT_S)
    if snap is None:
        return

    def on_change(name, nbytes):
        manifest.write_entry(data_dir, shard, pid=os.getpid(), sock="",
                             generation=1, epoch=0, shm=name,
                             shm_bytes=nbytes)

    client = SolverClient(data_dir, shard, on_segment_change=on_change,
                          device="cpu")
    try:
        while True:
            cmd = cmds.get(timeout=2 * ROUND_TIMEOUT_S)
            if cmd is None:
                break
            out = client.solve_fn(*cmd)(snap)
            replies.put((shard, client.last_solve, client.last_cause,
                         client.stale_accepted, digest(out)))
    finally:
        client.close(unlink=True)
        manifest.remove_entry(data_dir, shard)


def start_stacked_workers() -> dict:
    """Phase 4's ``SHARDS`` worker processes (``worker_loop``), started
    with their queues and the leader's data directory;
    ``wait_stacked_workers`` waits for their imports, ``stacked_phase``
    hands each its snapshot."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    data_dir = tempfile.mkdtemp(prefix="evg-chip-smoke-")
    replies = ctx.Queue()
    cmds = [ctx.Queue() for _ in range(SHARDS)]
    procs = [ctx.Process(target=worker_loop, args=(HERE, data_dir, k, cmds[k], replies),
                         daemon=True) for k in range(SHARDS)]
    for p in procs:
        p.start()
    return dict(data_dir=data_dir, replies=replies, cmds=cmds, procs=procs,
                t0=time.perf_counter())


def wait_stacked_workers(workers) -> float:
    """Wait until every phase 4 worker has done its imports (each says
    "ready"), so that none imports while the phases after phase 1 time
    and profile the card; returns the seconds waited."""
    t0 = time.perf_counter()
    ready = set()
    while len(ready) < SHARDS:
        try:
            op, shard = workers["replies"].get(timeout=1.0)
        except Exception:  # queue.Empty: see whether a worker died
            check(all(p.is_alive() for p in workers["procs"]),
                  f"a worker exited: {[p.exitcode for p in workers['procs']]}")
            check(time.perf_counter() - t0 < WORKER_WAIT_S, "workers never ready")
            continue
        check(op == "ready", f"worker {shard} said {op!r} before its snapshot")
        ready.add(shard)
    return time.perf_counter() - t0


def stacked_phase(torch, np, problem, cpu_out_tol, profile_dir, workers) -> None:
    """Phase 4; ``workers`` from ``start_stacked_workers``."""
    import shutil
    import threading

    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.packing import unpack
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.ops.solve import (
        OUTPUT_SPEC, _packed_solve, capacity_iters, distro_stats_inputs,
        result_to_host, run_solve_packed, split_outputs,
    )
    from evergreen_tpu_torch.parallel.sharded import (
        StackedSolveCache, _blocks_cap_iters, build_sharded_snapshot,
    )
    from evergreen_tpu_torch.runtime.manifest import write_entry
    from evergreen_tpu_torch.runtime.solver import (
        SolverClient, SolverService, reap_orphan_segments,
    )
    from evergreen_tpu_torch.utils.benchgen import NOW, add_capacity_page

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _, cold = build_sharded_snapshot(*problem, NOW, SHARDS)
    cold_s = time.perf_counter() - t0
    memos = {}
    build_sharded_snapshot(*problem, NOW, SHARDS, memos=memos)
    t0 = time.perf_counter()
    subs, warm = build_sharded_snapshot(*problem, NOW, SHARDS, memos=memos)
    warm_s = time.perf_counter() - t0
    check(list(warm) == list(cold) and all(
        warm[n].tobytes() == cold[n].tobytes() for n in cold),
        "warm sharded build differs from the cold one")
    for s, steps in zip(subs, SHARD_PAGES):
        if steps:
            add_capacity_page(s, steps)
    blocks = {k: s.arrays for k, s in enumerate(subs)}
    cap = _blocks_cap_iters(blocks)
    check(cap == max(SHARD_PAGES), f"stack trip count {cap}")
    check([capacity_iters(s) for s in subs] == list(SHARD_PAGES),
          "shard pages not as set")
    log(f"stacked: config 3 over {SHARDS} shards, shape key {subs[0].shape_key()}, "
        f"tasks {[s.n_tasks for s in subs]}, distros {[s.n_distros for s in subs]}; "
        f"sharded build cold {cold_s * 1e3:.0f} ms, warm {warm_s * 1e3:.0f} ms "
        f"(host), warm == cold byte for byte; pages {list(SHARD_PAGES)} steps, "
        f"stack trip count {cap}")
    # both kernels held against their plain versions at the shard shapes,
    # on each block unpacked on the card
    ds_err, ss_err = 0.0, {}
    for s in subs:
        a = unpack(s.arena.buffers, s.arena.layout_key(), dev)
        ds_args = distro_stats_inputs(a)
        ds_err = max(ds_err, hold_distro_stats(torch, ds_args))
        for pname, (seg, n_seg, live, x2, _) in segment_inputs(
                torch, np, a, ds_args[6]).items():
            _, err = hold_segment_sum(torch, pname, seg, n_seg, live, x2)
            ss_err[pname] = max(ss_err.get(pname, 0.0), err)
    log(f"stacked: on each of the {SHARDS} blocks, fused_distro_stats bit-equal "
        f"to plain on the CPU (max abs err vs plain on the card {ds_err:.3g}) "
        f"and segment_sum on its task, host and pool plans at k = 1, 2 bit-equal "
        f"to the CPU and within rtol {SUM_RTOL} of plain (max abs err "
        + ", ".join(f"{p} {e:.3g}" for p, e in ss_err.items()) + ")")
    want_round = expected_launches([cap] * SHARDS)

    # (a) the in-process stack on the card
    cache = StackedSolveCache()
    reset_launches(fused_distro_stats, segment_sum)
    stack = cache.solve_blocks(blocks)
    got = read_launches(fused_distro_stats, segment_sum)
    check(got == want_round, f"stacked launches {got}, expected {want_round}")
    for k, s in enumerate(subs):
        own = split_outputs(result_to_host(_packed_solve(
            s.arena.buffers, s.arena.layout_key(), cap, dev)), s.shape_key())
        check(digest(own) == digest(stack[k]),
              f"shard {k}: stacked block differs from its _packed_solve at {cap}")
    cpu = StackedSolveCache("cpu").solve_blocks(blocks)
    gaps = {}
    for k in range(SHARDS):
        for name, kind_, _ in OUTPUT_SPEC:
            c, w = stack[k][name], cpu[k][name]
            if kind_ == "i32":
                check(np.array_equal(c, w), f"shard {k}: {name} differs from the CPU")
            else:
                np.testing.assert_allclose(c, w, err_msg=f"shard {k}: {name}",
                                           **cpu_out_tol.get(name, dict(rtol=0.0, atol=0.0)))
                rel = np.abs(c - w) / np.maximum(np.abs(w), 1e-30)
                gaps[name] = max(gaps.get(name, 0.0), float(rel.max()) if len(c) else 0.0)
        check(bool(all(np.isfinite(stack[k][n]).all() for n in stack[k])),
              f"shard {k}: outputs not finite")
    log(f"stacked (a): StackedSolveCache on the card, launches {got} (exact); "
        f"each block byte-identical to its _packed_solve at {cap} steps; i32 "
        "equal to the CPU stack, f32 max relative gap "
        + ", ".join(f"{k}={v:.3g}" for k, v in gaps.items()))

    # (b) the solver-leader plane: rounds to worker processes, then to
    # clients in threads
    data_dir, replies = workers["data_dir"], workers["replies"]
    cmds, procs, clients = workers["cmds"], workers["procs"], {}
    svc = SolverService(data_dir, SHARDS, lease_ttl_s=5.0,
                        timeout_s=ROUND_TIMEOUT_S)
    want_digest = {k: digest(stack[k]) for k in stack}
    try:
        check(reap_orphan_segments(data_dir, SHARDS) == [], "orphan segments")
        check(svc.acquire(timeout_s=30.0), "solver lease not acquired")
        check(all(p.is_alive() for p in procs),
              f"a worker process exited: {[p.exitcode for p in procs]}")
        t0 = time.perf_counter()
        for k, q in enumerate(cmds):
            q.put(subs[k])
        spawn_ms = []
        for r in range(1 + THREAD_ROUNDS):
            stamp = svc.stamp()
            for q in cmds:
                q.put((stamp["epoch"], stamp["seq"], stamp["timeout_s"]))
            reset_launches(fused_distro_stats, segment_sum)
            t1 = time.perf_counter()
            outcome = svc.serve_round(list(range(SHARDS)), stamp["seq"])
            spawn_ms.append((time.perf_counter() - t1) * 1e3)
            got = read_launches(fused_distro_stats, segment_sum)
            answers = []
            deadline = time.monotonic() + ROUND_TIMEOUT_S
            while len(answers) < SHARDS and time.monotonic() < deadline:
                try:
                    answers.append(replies.get(timeout=1.0))
                except Exception:  # queue.Empty: see whether a worker died
                    check(all(p.is_alive() for p in procs),
                          f"a worker exited: {[p.exitcode for p in procs]}")
            check(len(answers) == SHARDS, "a worker did not reply")
            check(outcome == "stacked", f"process round {r} ended {outcome!r}")
            check(got == want_round, f"process round launches {got}, expected {want_round}")
            for shard, last, cause, stale, dig in answers:
                check(last == "stacked", f"worker {shard} solved {last}:{cause}")
                check(stale == 0, f"worker {shard} accepted a stale block")
                check(dig == want_digest[shard],
                      f"worker {shard}: block differs from the in-process stack")
            if r == 0:
                log(f"stacked (b): first round to {SHARDS} spawn worker processes "
                    f"ended '{outcome}', every worker 'stacked', blocks "
                    f"byte-identical to (a), launches {got} (exact); "
                    f"{time.perf_counter() - t0:.2f} s wall from the snapshots' "
                    f"handover (the processes started "
                    f"{t0 - workers['t0']:.2f} s before it, before the probe)")
        for q in cmds:
            q.put(None)
        for p in procs:
            p.join(timeout=60.0)
        check(all(p.exitcode == 0 for p in procs), "a worker process failed")
        log(f"stacked (b): {THREAD_ROUNDS} more rounds to the worker processes, "
            f"every round and worker 'stacked', blocks byte-identical to (a), "
            f"launches per round as above (exact); serve_round wall median "
            f"{statistics.median(spawn_ms[1:]):.2f} ms, min {min(spawn_ms[1:]):.2f} ms")

        for k in range(SHARDS):
            def on_change(name, nbytes, k=k):
                write_entry(data_dir, k, pid=os.getpid(), sock="", generation=2,
                            epoch=svc.epoch, shm=name, shm_bytes=nbytes)
            clients[k] = SolverClient(data_dir, k, on_segment_change=on_change)
        round_ms = []
        for _ in range(THREAD_ROUNDS):
            stamp = svc.stamp()
            results, threads = {}, []
            for k, c in clients.items():
                fn = c.solve_fn(stamp["epoch"], stamp["seq"], stamp["timeout_s"])
                t = threading.Thread(
                    target=lambda k=k, fn=fn: results.__setitem__(k, fn(subs[k])),
                    daemon=True)
                t.start()
                threads.append(t)
            reset_launches(fused_distro_stats, segment_sum)
            t0 = time.perf_counter()
            outcome = svc.serve_round(list(clients), stamp["seq"])
            round_ms.append((time.perf_counter() - t0) * 1e3)
            got = read_launches(fused_distro_stats, segment_sum)
            for t in threads:
                t.join(timeout=ROUND_TIMEOUT_S)
            check(not any(t.is_alive() for t in threads), "a client thread hung")
            check(outcome == "stacked", f"thread round ended {outcome!r}")
            check(got == want_round, f"thread round launches {got}, expected {want_round}")
            for k, c in clients.items():
                check(c.last_solve == "stacked", f"client {k}: {c.last_solve}:{c.last_cause}")
                check(digest(results[k]) == digest(stack[k]),
                      f"client {k}: block differs from the in-process stack")
        check(svc.round_outcomes == {"stacked": 1 + 2 * THREAD_ROUNDS},
              f"round outcomes {svc.round_outcomes}")
        check(all(c.stale_accepted == 0 and not c.fallbacks for c in clients.values()),
              "a client fell back or accepted a stale block")
    finally:
        for c in clients.values():
            c.close(unlink=True)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        svc.stop()
        shutil.rmtree(data_dir, ignore_errors=True)
    log(f"stacked (b): {THREAD_ROUNDS} rounds to clients in threads (the leader's "
        f"process), every round and client 'stacked', blocks byte-identical to "
        f"(a), launches per round {want_round} (exact); serve_round wall median "
        f"{statistics.median(round_ms):.2f} ms, min {min(round_ms):.2f} ms "
        f"(collect + stacked solve + return)")

    stack_ms, seq_ms = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        cache.solve_blocks(blocks)
        stack_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for s in subs:
            run_solve_packed(s)
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"stacked: in-process solve_blocks ({SHARDS} x {cap} steps) wall median "
        f"{statistics.median(stack_ms):.2f} ms, min {min(stack_ms):.2f} ms; "
        f"{SHARDS} sequential run_solve_packed (own pages {list(SHARD_PAGES)}) "
        f"median {statistics.median(seq_ms):.2f} ms, min {min(seq_ms):.2f} ms")
    if profile_dir:
        # (in the default run since cut: phase 9's profiled round measures
        # the stacked solve's device time and idle share on the service's path)
        log("stacked: profile of one in-process solve_blocks")
        profile_solve(torch, lambda: cache.solve_blocks(blocks),
                      os.path.join(profile_dir, "stacked"))


def diff_spans(np, before, after) -> dict:
    """Each kind's [lo, hi) runs of elements whose bytes changed."""
    spans = {}
    for kind, new in after.items():
        width = {1: np.uint8, 4: np.uint32}[new.itemsize]
        idx = np.flatnonzero(before[kind].view(width) != new.view(width))
        cuts = np.flatnonzero(np.diff(idx) > 1) + 1
        starts = np.concatenate([[0], cuts]) if len(idx) else []
        ends = np.concatenate([cuts, [len(idx)]]) if len(idx) else []
        spans[kind] = [(int(idx[a]), int(idx[b - 1]) + 1)
                       for a, b in zip(starts, ends)]
    return spans


def predict_mirror(spans, shapes, run_min) -> dict:
    """The counter moves a delta sync of disjoint, non-adjacent ``spans``
    should make: runs of ``run_min`` or more ship as slices, the rest
    through the index vector unless it covers half of its kind or more,
    which ships the kind whole."""
    d = {"full_uploads": 0, "slice_rows": 0, "delta_rows": 0}
    for kind, sp in spans.items():
        sparse = sum(hi - lo for lo, hi in sp if hi - lo < run_min)
        if 2 * sparse >= shapes[kind]:
            d["full_uploads"] += 1
        else:
            d["slice_rows"] += sum(hi - lo for lo, hi in sp if hi - lo >= run_min)
            d["delta_rows"] += sparse
    return d


def mirror_phase(torch, np, problem) -> None:
    """Phase 5."""
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.resident_ops import SLICE_RUN_MIN, DeviceMirror
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.ops.solve import (
        _packed_solve, capacity_iters, result_to_host, run_solve_packed,
        split_outputs,
    )
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.utils.benchgen import NOW

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    snap = build_snapshot(*problem, NOW)
    t_f32 = [n for n, kind, _ in snap.arena.layout_key()
             if kind == "f32" and n[:2] in ("t_", "u_")]

    def time_refresh(s):
        later = build_snapshot(*problem, NOW + 15.0)
        for kind, buf in later.arena.buffers.items():
            s.arena.buffers[kind][:] = buf
        return s

    def scattered(s):
        a = s.arrays
        rows = rng.choice(s.n_tasks, 200, replace=False)
        a["t_priority"][rows[:100]] += 7
        a["t_expected_s"][rows[100:]] *= 1.5
        hosts = rng.choice(s.n_hosts, 100, replace=False)
        a["h_free"][hosts] ^= True
        return s

    def dense_f32(s):
        # three of every four elements of the task and unit f32 columns:
        # short runs, over half of the f32 buffer in all
        for name in t_f32:
            col = s.arrays[name]
            col[np.arange(len(col)) % 4 != 3] += 1.0
        return s

    steps = [
        ("cold sync", lambda s: s),
        ("time refresh (NOW + 15 s)", time_refresh),
        ("300 scattered rows", scattered),
        ("sparse part over half of f32", dense_f32),
        ("layout change (N bucket doubled)", lambda s: build_snapshot(
            *problem, NOW, force_dims={"N": 2 * s.shape_key()[0]})),
    ]
    # the first copy_/index_copy_ of each dtype loads its kernels: do it
    # on a small mirror, so the steps' sync times are steady ones
    small = {k: np.zeros(256, v.dtype) for k, v in snap.arena.buffers.items()}
    warm = DeviceMirror()
    warm.sync(small, None)
    warm.sync(small, {k: [(0, 2 * SLICE_RUN_MIN), (200, 201)] for k in small})
    mirror = DeviceMirror()
    full_bytes = sum(v.nbytes for v in snap.arena.buffers.values())
    prev = None
    for label, step in steps:
        snap = step(snap)
        truth = snap.arena.buffers
        shapes = {k: len(v) for k, v in truth.items()}
        same = prev is not None and shapes == {k: len(v) for k, v in prev.items()}
        spans = diff_spans(np, prev, truth) if same else None
        before = {k: getattr(mirror, k) for k in ("full_uploads", "slice_rows",
                                                    "delta_rows", "bytes_uploaded")}
        want = (predict_mirror(spans, shapes, SLICE_RUN_MIN) if spans is not None
                else {"full_uploads": 1, "slice_rows": 0, "delta_rows": 0})
        t0 = time.perf_counter()
        bufs = mirror.sync(truth, spans)
        torch.cuda.synchronize(dev)
        sync_ms = (time.perf_counter() - t0) * 1e3
        moved = {k: getattr(mirror, k) - v for k, v in before.items()}
        check({k: moved[k] for k in want} == want,
              f"mirror {label}: counters moved {moved}, predicted {want}")
        for kind, src in truth.items():
            check(bufs[kind].device == dev
                  and bufs[kind].cpu().numpy().tobytes() == src.tobytes(),
                  f"mirror {label}: {kind} differs from the host truth")
        iters = capacity_iters(snap)
        reset_launches(fused_distro_stats, segment_sum)
        fed = result_to_host(_packed_solve(bufs, snap.arena.layout_key(), iters, dev))
        got = read_launches(fused_distro_stats, segment_sum)
        check(got == expected_launches([iters]),
              f"mirror {label}: launches {got}")
        fresh = run_solve_packed(snap)
        check(digest(split_outputs(fed, snap.shape_key())) == digest(fresh),
              f"mirror {label}: solve differs from a fresh upload's")
        n_spans = sum(len(v) for v in spans.values()) if spans else 0
        log(f"mirror {label}: {n_spans} spans, counters moved "
            f"{ {k: moved[k] for k in want} } (as predicted); H2D "
            f"{moved['bytes_uploaded']} B against a full upload's "
            f"{sum(v.nbytes for v in truth.values())} B; sync {sync_ms:.2f} ms wall; "
            f"mirror == truth, its solve == a fresh upload's (launches {got})")
        prev = {k: v.copy() for k, v in truth.items()}
    # each kind of update ran: slices and an index vector on the time
    # refresh, full uploads cold, for the dense f32 step and the layout
    check(mirror.full_uploads == 3 and mirror.slice_rows > 0 and mirror.delta_rows > 0,
          "the churn sequence did not exercise every kind of update")
    log(f"mirror: totals full_uploads {mirror.full_uploads}, slice_rows "
        f"{mirror.slice_rows}, delta_rows {mirror.delta_rows}, "
        f"{mirror.bytes_uploaded} B H2D over {len(steps)} steps (config 3 "
        f"arena {full_bytes} B)")


#: phase 6: the capacity settings bench.py's capacity arm gives config 3,
#: and the solve deadline of the second two-call run
PLAN_QUOTA = {"mock": 5400}
PLAN_BUDGET = 500
PLAN_DEADLINE_S = 5.0
#: the one float of the planning chain's documents that the card may
#: round otherwise than the CPU: the capacity relaxation's x (from Newton
#: steps with pow and division), rounded to this unit in the provenance
FRACTIONAL_UNIT = 1e-3
RUNGS = ("fused", "two_call", "heuristic")


def plan_tick(store, now, solve_fn=None, deadline_s=0.0, device=None) -> dict:
    """The planning chain of the tick through the port (the JAX
    ``run_tick`` body without the cmp planner, the serial fallback, the
    persister and intent creation): intent budget, capacity page,
    snapshot, bounded solve, unpack, the alias and single-task rules,
    the capacity plane (its two-call rung on ``device``). Returns its
    outputs, the moves of the counters that show a fallback, and each
    step's wall time."""
    from evergreen_tpu_torch.globals import ALIAS_SUFFIX, MAX_INTENT_HOSTS_IN_FLIGHT
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.scheduler import capacity_plane as plane_mod
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot, pack_capacity_page
    from evergreen_tpu_torch.utils.circuit import BREAKER_FAILURES

    fused0 = {k: plane_mod.FUSED_SOLVES.value(mode=k) for k in RUNGS}
    solves0 = plane_mod.CAPACITY_SOLVES.total()
    fallbacks0 = plane_mod.CAPACITY_FALLBACKS.total()
    failures0 = BREAKER_FAILURES.value(name="scheduler.solve")
    ms = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return r

    budget = max(0, MAX_INTENT_HOSTS_IN_FLIGHT - host_mod.count_intents_in_flight(store))
    distros, tbd, hbd, est, deps_met = timed(
        "gather_tick_inputs", wrapper.gather_tick_inputs, store, now)
    distros = wrapper._apply_release_mode(store, distros)
    plane = plane_mod.capacity_plane_for(store)
    page = plane.build_capacity_page(quota_scale=1.0, intent_budget=budget)
    snap = timed("build_snapshot", build_snapshot, distros, tbd, hbd, est, deps_met, now)
    pack_capacity_page(snap.arrays, page)
    breaker = wrapper.solve_breaker_for(store)
    check(breaker.allow(now=now), "the solve breaker is open")
    try:
        out = timed("_solve_bounded", wrapper._solve_bounded, store, snap, deadline_s,
                    solve_fn=solve_fn)
    except Exception as exc:
        breaker.record_failure(now=now, error=repr(exc))
        raise
    breaker.record_success(now=now)
    plans, sort_values, infos, new_hosts, _, _, provenance = timed(
        "_unpack_solve", wrapper._unpack_solve, snap, out)
    d_pool, d_cap = snap.arrays["d_pool"], snap.arrays["d_cap_on"]
    packed_cols = {did: (int(d_pool[i]), bool(d_cap[i]))
                   for i, did in enumerate(snap.distro_ids)}
    fused = plane_mod.extract_fused_view(snap, out) if page is not None else None
    for k in [k for k in new_hosts if k.endswith(ALIAS_SUFFIX)]:
        del new_hosts[k]
    for d in distros:
        if d.single_task_distro and d.id in new_hosts:
            info = infos.get(d.id)
            demand = info.length_with_dependencies_met if info else 0
            existing = len(hbd.get(d.id, []))
            cap = d.host_allocator_settings.maximum_hosts or demand
            new_hosts[d.id] = max(0, min(demand, cap - existing))
    before = dict(new_hosts)
    after = timed("apply", plane.apply, distros, infos, new_hosts, hbd, now,
                  degraded=False, quota_scale=1.0, intent_budget=budget,
                  packed_cols=packed_cols, fused=fused, device=device)
    return dict(
        snap=snap, out=out, plans=plans, sort_values=sort_values, infos=infos,
        before=before, after=after, provenance=provenance, fused=fused,
        capacity=store._last_capacity, ms=ms,
        rungs={k: plane_mod.FUSED_SOLVES.value(mode=k) - fused0[k] for k in RUNGS},
        capacity_solves=plane_mod.CAPACITY_SOLVES.total() - solves0,
        fallbacks=plane_mod.CAPACITY_FALLBACKS.total() - fallbacks0,
        solve_failures=BREAKER_FAILURES.value(name="scheduler.solve") - failures0,
        solve_breaker=breaker.state, fused_breaker=plane.fused_breaker.state,
    )


def close_docs(got, want, path=""):
    """Whether two documents are equal: exactly, but for the capacity
    relaxation's ``fractional``, which may differ by ``SUM_RTOL`` or the
    unit it is rounded to."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{path}: keys differ")
        for k in want:
            close_docs(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{path}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            close_docs(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and path.endswith(".fractional"):
        # values of x within SUM_RTOL may round one unit apart
        check(abs(got - want) <= max(SUM_RTOL * abs(want), FRACTIONAL_UNIT * (1 + 1e-6)),
              f"{path}: {got} != {want}")
    else:
        check(type(got) is type(want) and got == want, f"{path}: {got!r} != {want!r}")


def same_tick(card, cpu, label) -> None:
    """The card's chain outputs against the CPU's: plans, sort values,
    spawn counts, rung, capacity targets, queue info and provenance
    exactly, but for ``fractional`` (``close_docs``)."""
    check(list(card["plans"]) == list(cpu["plans"]), f"{label}: distros differ")
    for did in cpu["plans"]:
        check([t.id for t in card["plans"][did]] == [t.id for t in cpu["plans"][did]],
              f"{label}: plan of {did} differs from the CPU's")
        check(card["sort_values"][did].tobytes() == cpu["sort_values"][did].tobytes(),
              f"{label}: sort values of {did} differ from the CPU's")
        close_docs(card["infos"][did].doc(), cpu["infos"][did].doc(), f"{label}: info[{did}]")
        close_docs(card["provenance"].to_doc(did, limit=10**9),
                   cpu["provenance"].to_doc(did, limit=10**9), f"{label}: prov[{did}]")
    for key in ("before", "after", "rungs", "capacity_solves", "fallbacks"):
        check(card[key] == cpu[key], f"{label}: {key} differs from the CPU's")
    check(card["capacity"].chosen == cpu["capacity"].chosen, f"{label}: chosen differs")
    close_docs(card["capacity"].to_doc(limit=10**9), cpu["capacity"].to_doc(limit=10**9),
               f"{label}: capacity")


def planning_phase(torch, np) -> None:
    """Phase 6."""
    import functools
    import threading

    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.ops import capacity as cap_ops
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.ops.solve import OUTPUT_SPEC, capacity_iters, run_solve_packed
    from evergreen_tpu_torch.scheduler.capacity_plane import build_fused_inputs
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils.benchgen import NOW, generate_problem

    distros, tbd, hbd, _, _ = generate_problem(*CONFIG3, seed=SEED)
    store = Store()
    t0 = time.perf_counter()
    for d in distros:
        distro_mod.insert(store, d)
    task_mod.insert_many(store, [t for ts in tbd.values() for t in ts])
    for hs in hbd.values():
        host_mod.insert_many(store, hs)
    insert_ms = (time.perf_counter() - t0) * 1e3
    coll = distro_mod.coll(store)
    for doc in coll.find():
        ps = dict(doc["planner_settings"])
        ps["capacity"] = "tpu"
        coll.update(doc["_id"], {"planner_settings": ps})
    log(f"planning: config 3 (seed {SEED}) inserted into the port's Store: "
        f"{len(distros)} distros, {task_mod.coll(store).count()} tasks, "
        f"{host_mod.coll(store).count()} hosts in {insert_ms:.0f} ms (host); every "
        f"distro opted into the capacity program, quota {PLAN_QUOTA}, fleet intent "
        f"budget {PLAN_BUDGET}")

    def configure(fused):
        CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET,
                       fused=fused).set(store)

    # the CPU reference runs: the solve and the two-call program on the CPU
    cpu = {}
    for fused in ("auto", "two_call"):
        configure(fused)
        cpu[fused] = plan_tick(store, NOW, solve_fn=functools.partial(
            run_solve_packed, device="cpu"), device="cpu")

    iters = capacity_iters(cpu["auto"]["snap"])
    check(iters == CapacityConfig().iterations, f"capacity page iterations {iters}")
    # launches: the packed solve's, and the two-call program's pool sums —
    # the minimum mass once and each projection (warm start and steps)
    want_fused = expected_launches([iters])
    want_two = dict(want_fused)
    for k in ("segment_sum", "segment_sum[pool]"):
        want_two[k] += 2 + iters
    runs = {}
    for label, fused, deadline in (("fused", "auto", 0.0),
                                   ("two_call", "two_call", 0.0),
                                   ("two_call+deadline", "two_call", PLAN_DEADLINE_S)):
        configure(fused)
        reset_launches(fused_distro_stats, segment_sum)
        r = plan_tick(store, NOW, deadline_s=deadline)
        r["launches"] = read_launches(fused_distro_stats, segment_sum)
        runs[label] = r
        rung = "fused" if fused == "auto" else "two_call"
        check(r["solve_failures"] == 0 and r["solve_breaker"] == "closed",
              f"{label}: the solve breaker saw a failure")
        check(r["fallbacks"] == 0, f"{label}: scheduler_capacity_fallbacks_total moved")
        check(r["fused_breaker"] == "closed", f"{label}: the fused breaker is open")
        check(r["rungs"] == {k: int(k == rung) for k in RUNGS},
              f"{label}: rungs {r['rungs']}, expected one {rung}")
        check(r["capacity_solves"] == (0 if rung == "fused" else 1),
              f"{label}: scheduler_capacity_solves_total moved {r['capacity_solves']}")
        want = want_fused if rung == "fused" else want_two
        check(r["launches"] == want, f"{label}: launches {r['launches']}, expected {want}")
        same_tick(r, cpu[fused], label)
        out = r["out"]
        check(all(np.isfinite(out[n]).all() for n, k_, _ in OUTPUT_SPEC if k_ == "f32"),
              f"{label}: outputs not finite")
        check(sum(len(p) for p in r["plans"].values()) == r["snap"].n_tasks,
              f"{label}: plans do not hold every task once")
        check(min(r["after"].values()) >= 0, f"{label}: negative spawn count")
    check(not any(t.name == "tick-solve" and t.is_alive() for t in threading.enumerate()),
          "the deadline's solve thread outlived its solve")
    f, c, c2 = runs["fused"], runs["two_call"], runs["two_call+deadline"]
    check(f["after"] == c["after"] and f["before"] == c["before"],
          "fused and two-call spawn counts differ")
    check(f["capacity"].to_doc(limit=10**9)["distros"]
          == c["capacity"].to_doc(limit=10**9)["distros"],
          "fused and two-call targets differ")
    check(digest(c["out"]) == digest(c2["out"]) and c["after"] == c2["after"]
          and c["capacity"].to_doc(limit=10**9)["distros"]
          == c2["capacity"].to_doc(limit=10**9)["distros"],
          "the two two-call runs (no deadline, and a deadline) differ")
    moved = sum(1 for d, n in f["after"].items() if n != f["before"][d])
    log(f"planning: planner tpu on every run, no fallback counter moved, breakers "
        f"closed; rungs fused / two_call / two_call as configured; card == CPU (plans, "
        f"sort values, spawn counts, targets, queue info, provenance exact; the "
        f"relaxation's fractional x within rtol {SUM_RTOL} or {FRACTIONAL_UNIT}); "
        f"fused == two-call targets and rounded allocations; the two two-call runs "
        f"(deadline 0 and {PLAN_DEADLINE_S} s) byte-identical; capacity chose "
        f"'{f['capacity'].chosen}', {sum(f['before'].values())} heuristic intents -> "
        f"{sum(f['after'].values())} ({moved} distros moved)")
    log("planning launches: " + json.dumps({k: r["launches"] for k, r in runs.items()}))

    # the two-call program alone, at the fused program's padded D: x is
    # the packed solve's cap_x bit for bit, and repeats byte for byte
    inp = build_fused_inputs(f["fused"])
    d_pad = f["fused"]["d_pad"]
    xs, cap_ms = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        xs.append(cap_ops.run_capacity_solve(inp, d_pad=d_pad))
        cap_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(x.tobytes() == f["fused"]["cap_x"][: inp.n].tobytes() for x in xs),
          "run_capacity_solve differs from the packed solve's cap_x")
    ms = {k: [r["ms"][k] for r in runs.values()] for k in f["ms"]}
    log("planning wall (ms; fused, two_call, two_call+deadline): inserts "
        f"{insert_ms:.1f}; " + "; ".join(
            f"{k} " + ", ".join(f"{v:.2f}" for v in vs) for k, vs in ms.items())
        + f"; run_capacity_solve alone ({inp.n} rows at D {d_pad}, {iters} steps) "
        f"median {statistics.median(cap_ms):.2f} ms, min {min(cap_ms):.2f} ms over 7, "
        f"x == cap_x bit for bit")
    # (a profile of one run_capacity_solve was cut for phase 13: phase 3
    # profiles the same capacity solve, run_solve_packed on seed0+cap)


#: phase 7: the ticks' logical times and how many tasks the churn between
#: the two solve ticks touches in each of its four ways
TICK_STEP_S = 15.0
TICK_CHURN = 300
#: the ticks phase 7 runs, by index: the two solve ticks and the one with
#: the solve breaker held open; the third, a solve fault, was cut when
#: phase 13 needed the time (phase 8's cold card store runs the same
#: solve-fault tick)
PHASE7_TICKS = (0, 1, 3)
#: the wall-time phases of a tick (TICK_PHASE_MS labels, in pipeline order)
TICK_PHASES = ("delta_drain", "pack", "solve", "unpack", "cmp", "capacity",
               "persist")
#: the collections a tick writes
TICK_COLLECTIONS = ("task_queues", "task_secondary_queues", "tasks", "hosts",
                    "events", "overload_sheds")
SHAPES = ("skipped", "patched", "spliced", "rewritten")
#: what two runs of the same tick cannot agree on in a span document: its
#: ids (each process numbers its spans), its times, and the thread; and
#: the span attributes that are wall times
SPAN_MASK = ("_id", "parent", "trace_root", "started_at", "duration_ms", "thread")
SPAN_TIME_ATTRS = ("snapshot_ms", "solve_ms", "total_ms")
#: what a store whose resident plane and persister are fresh (reopened, or
#: a new lease holder's) records otherwise than a live store: the plane
#: rebuilds where the live one applies deltas, the persister rewrites what
#: the live one patches or skips
FRESH_ATTRS = ("rebuild_reason", "skip", "patch", "splice", "rewrite")
#: a tick's spans: the root, its phases, the resident plane's
TICK_SPANS = ("tick", "delta_drain", "resident_apply", "pack", "arena_lease", "solve",
              "unpack", "persist", "tick_stats", "wal_commit")


def is_span(doc) -> bool:
    return "trace_root" in doc and "component" in doc


def canon_span(doc, live=True) -> dict:
    """A span document with ``SPAN_MASK`` and the time attributes masked,
    and ``FRESH_ATTRS`` too unless ``live``."""
    attrs = {k: v for k, v in doc["attributes"].items()
             if k not in SPAN_TIME_ATTRS and (live or k not in FRESH_ATTRS)}
    return dict({k: v for k, v in doc.items() if k not in SPAN_MASK}, attributes=attrs)


def span_json(store, live=True) -> str:
    """The store's ``spans`` documents in store order, masked
    (``canon_span``), without ``arena_lease``: the CPU publish leases a
    transfer arena, the card's goes through the device mirror and leases
    none."""
    return json.dumps([canon_span(d, live) for d in store.collection("spans").find()
                       if d["name"] != "arena_lease"],
                      sort_keys=True, separators=(",", ":"), default=str)


def tree_shape(store, trace_id, lease=True):
    """One trace's span tree as nested [span masked, children sorted]
    (``utils/tracing.py::trace_tree``), ``arena_lease`` dropped unless
    ``lease``."""
    from evergreen_tpu_torch.utils.tracing import trace_tree

    def shape(node):
        kids = [shape(c) for c in node["children"] if lease or c["name"] != "arena_lease"]
        span = {k: v for k, v in node.items() if k != "children"}
        return [json.dumps(canon_span(span), sort_keys=True, default=str),
                sorted(kids, key=json.dumps)]

    tree = trace_tree(store, trace_id)
    check(tree is not None, f"trace {trace_id!r} is unknown")
    return sorted((shape(r) for r in tree["roots"]), key=json.dumps)


def cold_tree_names(degraded="") -> list:
    """The span names of a cold tick's tree: every phase on a solve tick;
    no ``unpack`` when the solve raised; no ``pack`` or ``solve`` either
    when the breaker was open."""
    skip = {"resident_apply", "arena_lease"}
    if degraded == "solve-failed":
        skip.add("unpack")
    elif degraded == "breaker-open":
        skip.update(("pack", "solve", "unpack"))
    return sorted(n for n in TICK_SPANS if n not in skip)


def tree_names(shape) -> list:
    """The span names of a ``tree_shape``, sorted."""
    out = []

    def walk(node):
        out.append(json.loads(node[0])["name"])
        for c in node[1]:
            walk(c)

    for r in shape:
        walk(r)
    return sorted(out)


def agent_pass(store, now) -> tuple:
    """The fleet worker's harness agent (``ShardWorker.op_agent_sim``) on
    ``store``: finish every task in flight (``mark_task_started``, then
    ``mark_end`` with success), then pull for every free host in id order
    through a fresh ``DispatcherService``. Returns (the finished ids,
    the (host, task) pairs, the pulls' wall ms, the finishing's wall
    ms)."""
    from evergreen_tpu_torch.dispatch.assign import assign_next_available_task
    from evergreen_tpu_torch.dispatch.dag_dispatcher import DispatcherService
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models.lifecycle import mark_end, mark_task_started

    tasks = store.collection("tasks")
    finished = sorted(d["_id"] for d in tasks.find(
        lambda d: d["status"] in ("dispatched", "started")))
    t0 = time.perf_counter()
    for tid in finished:
        mark_task_started(store, tid, now=now)
        mark_end(store, tid, "success", now=now)
    finish_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    svc = DispatcherService(store)
    hosts = sorted((h for h in host_mod.find(store)
                    if h.can_run_tasks() and not h.running_task), key=lambda h: h.id)
    pairs = []
    for h in hosts:
        t = assign_next_available_task(store, svc, h, now=now)
        pairs.append((h.id, t.id if t is not None else None))
    return finished, pairs, (time.perf_counter() - t0) * 1e3, finish_ms


def seed_tick_store(store, problem, only=None) -> None:
    """Config 3 in ``store`` with phase 6's capacity settings: every
    distro of ``problem`` with its tasks and hosts, or those of the
    distro ids in ``only``."""
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.settings import CapacityConfig

    distros, tbd, hbd, _, _ = problem
    if only is not None:
        distros = [d for d in distros if d.id in only]
    for d in distros:
        distro_mod.insert(store, d)
        coll = distro_mod.coll(store)
        ps = dict(coll.get(d.id)["planner_settings"])
        ps["capacity"] = "tpu"
        coll.update(d.id, {"planner_settings": ps})
    task_mod.insert_many(store, [t for d in distros for t in tbd[d.id]])
    for d in distros:
        host_mod.insert_many(store, hbd[d.id])
    CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET).set(store)


def tick_churn(store, now) -> None:
    """The same churn on any store, in the first half of the distros:
    TICK_CHURN runnable tasks dispatched, as many finished, as many
    re-prioritised, and as many new ones (copies of others, unstamped and
    without dependencies). The other half's queues change only with the
    clock and the intents of the tick before."""
    import copy
    import random

    rng = random.Random(SEED)
    tasks = store.collection("tasks")
    ids = sorted(d["_id"] for d in store.collection("distros").find())
    churned = set(ids[: len(ids) // 2])
    live = [d["_id"] for d in tasks.find()
            if d["status"] == "undispatched" and d["activated"]
            and d["distro_id"] in churned]
    rng.shuffle(live)
    n = TICK_CHURN
    for tid in live[:n]:
        tasks.update(tid, {"status": "dispatched", "dispatch_time": now})
    for tid in live[n:2 * n]:
        tasks.update(tid, {"status": "success", "finish_time": now})
    for tid in live[2 * n:3 * n]:
        tasks.update(tid, {"priority": rng.choice([0, 5, 60])})
    new = []
    for k, tid in enumerate(live[3 * n:4 * n]):
        doc = copy.deepcopy(tasks.get(tid))
        doc.update(_id=f"{tid}-new{k}", scheduled_time=0.0,
                   dependencies_met_time=0.0, depends_on=[], activated_time=now)
        new.append(doc)
    tasks.insert_many(new)


class GcClock:
    """Wall ms the cyclic garbage collector spends while installed in
    ``gc.callbacks``, and how many of its collections were full
    (generation 2)."""

    def __init__(self):
        self.ms = 0.0
        self.full = 0
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2
            self._t0 = None


class untuned_gc:
    """The interpreter's default collector inside the block (the objects
    ``gc.freeze`` kept out of its scans back in them, its starting
    thresholds), phase 8's tuning (``tune_gc_for_long_lived_heap``) again
    after it: phase 7 measures the collector's share of an untuned
    tick, and runs after phase 8."""

    def __enter__(self):
        import gc

        self.thresholds = gc.get_threshold()
        self.frozen = gc.get_freeze_count() > 0
        gc.unfreeze()
        gc.set_threshold(*_GC_THRESHOLDS)

    def __exit__(self, *exc):
        import gc

        if self.frozen:
            gc.freeze()
        gc.set_threshold(*self.thresholds)


def tick_phase(torch, np, problem, card="cuda", card_first=True, ticks=None) -> dict:
    """Phase 7, ticking the card's store before the CPU's at each step
    when ``card_first``, else after it; ``ticks`` runs only the steps of
    those indices (None: all four). Returns the launches of its ticks on
    ``card``."""
    import gc
    import itertools
    import random
    import uuid

    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.persister import persister_state_for
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import faults
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    stores = {card: Store(), "cpu": Store()}
    t0 = time.perf_counter()
    for store in stores.values():
        seed_tick_store(store, problem)
    order = (card, "cpu") if card_first else ("cpu", card)
    log(f"tick: config 3 (seed {SEED}) in a store for the card and one for the "
        f"CPU, {time.perf_counter() - t0:.2f} s wall for both; capacity quota "
        f"{PLAN_QUOTA}, fleet intent budget {PLAN_BUDGET}; each step ticks "
        f"{order[0]} first, after a full gc.collect() before each tick")
    seqs = {k: itertools.count() for k in stores}
    real_uuid4, real_time = uuid.uuid4, time.time

    def tick(key, k, now, opts):
        """Tick ``key``'s store; the k-th tick of each store draws the same
        uuid4 stream, reads the same clock and continues its own event
        sequence."""
        rng = random.Random(1000 + k)
        uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128))
        time.time = lambda: now
        event_mod._SEQ = seqs[key]
        try:
            return wrapper.run_tick(stores[key], opts, now=now, device=key)
        finally:
            uuid.uuid4, time.time = real_uuid4, real_time

    def break_solve(store):
        breaker = wrapper.solve_breaker_for(store)
        for _ in range(wrapper.SOLVE_BREAKER_THRESHOLD):
            breaker.record_failure(now=NOW + 3 * TICK_STEP_S, error="held open")

    steps = [
        ("1", NOW, None, None, "tpu", ""),
        ("2 (after churn)", NOW + TICK_STEP_S, tick_churn, None, "tpu", ""),
        ("3 (solve fault)", NOW + 2 * TICK_STEP_S, None,
         faults.FaultPlan().always("scheduler.solve", faults.Fault("raise")),
         "serial", "solve-failed"),
        ("4 (breaker open)", NOW + 3 * TICK_STEP_S, lambda st, now: break_solve(st),
         None, "serial", "breaker-open"),
    ]
    total = {}
    for k, (label, now, before, plan, planner, degraded) in enumerate(steps):
        if ticks is not None and k not in ticks:
            continue
        if before is not None:
            for store in stores.values():
                before(store, now)
        results, shapes, phases, gcs = {}, {}, {}, {}
        for key in order:
            state = persister_state_for(stores[key])
            shapes0 = [getattr(state, s_) for s_ in SHAPES]
            phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in TICK_PHASES}
            if plan is not None:
                faults.install(plan)
            gc.collect()
            gcs[key] = GcClock()
            gc.callbacks.append(gcs[key])
            reset_launches(fused_distro_stats, segment_sum)
            try:
                results[key] = tick(key, k, now, wrapper.TickOptions())
            finally:
                gc.callbacks.remove(gcs[key])
                faults.uninstall()
            if key == card:
                launches = read_launches(fused_distro_stats, segment_sum)
            shapes[key] = {s_: getattr(state, s_) - v for s_, v in zip(SHAPES, shapes0)}
            phases[key] = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p]
                           for p in TICK_PHASES}
        r, c = results[card], results["cpu"]
        check(r.planner_used == planner and r.degraded == degraded,
              f"{label}: planner {r.planner_used!r}, degraded {r.degraded!r}")
        for field in ("queues", "new_hosts", "n_tasks", "n_distros", "planner_used",
                      "degraded", "shed", "overload"):
            check(getattr(r, field) == getattr(c, field),
                  f"{label}: TickResult.{field} differs from the CPU's")
        check([h.to_doc() for h in r.intent_hosts] == [h.to_doc() for h in c.intent_hosts],
              f"{label}: intent hosts differ from the CPU's")
        check(shapes[card] == shapes["cpu"], f"{label}: persister shapes "
              f"{shapes[card]} differ from the CPU's {shapes['cpu']}")
        n_docs = 0
        for name in TICK_COLLECTIONS:
            got = stores[card].collection(name).find()
            want = stores["cpu"].collection(name).find()
            check(len(got) == len(want), f"{label}: {name} count differs")
            for g, w in zip(got, want):
                check(g == w, f"{label}: {name} document {w.get('_id')!r} differs "
                      f"from the CPU's")
            n_docs += len(got)
        check(span_json(stores[card]) == span_json(stores["cpu"]),
              f"{label}: the span documents differ from the CPU's")
        names = tree_names(tree_shape(stores[card], r.trace_id))
        check(names == cold_tree_names(degraded), f"{label}: the tick's span tree {names}")
        want_launches = (expected_launches([CapacityConfig().iterations])
                         if planner == "tpu" and on_card else
                         {"fused_distro_stats": 0, "segment_sum": 0})
        check(launches == want_launches, f"{label}: launches {launches}, "
              f"expected {want_launches}")
        for k_, v in launches.items():
            total[k_] = total.get(k_, 0) + v
        log(f"tick {label}: planner {r.planner_used}, degraded {r.degraded!r}, "
            f"overload {r.overload}, shed {r.shed}; {sum(r.queues.values())} queue "
            f"items in {len(r.queues)} queues, {len(r.intent_hosts)} intents; "
            f"persister {shapes[card]}; {n_docs} documents == the CPU's; "
            f"launches {launches} (exact)")
        if planner == "tpu":
            log(f"tick {label} wall ({order[0]} first; ms, card / CPU): " + "; ".join(
                f"{p} {phases[card][p]:.2f} / {phases['cpu'][p]:.2f}"
                for p in TICK_PHASES)
                + f"; whole tick {r.total_ms:.2f} / {c.total_ms:.2f}; of it in "
                f"the garbage collector {gcs[card].ms:.2f} / {gcs['cpu'].ms:.2f} "
                f"({gcs[card].full} / {gcs['cpu'].full} full collections)")
        if k == 0:
            check(shapes[card]["rewritten"] == len(r.queues),
                  f"{label}: not every queue was written")
            check(r.intent_hosts, f"{label}: no intent hosts")
        if k == 1:
            # the churned half splices; the other half patches, or skips
            # where neither the clock nor the intents moved its queue
            check(shapes[card]["rewritten"] == 0 and shapes[card]["spliced"] > 0
                  and shapes[card]["patched"] + shapes[card]["skipped"] > 0,
                  f"{label}: persister shapes {shapes[card]}: expected splices, "
                  f"and patches or skips, and no rewrite")
    return total


#: the hand kernels' names in a profiler trace (their __global__ names)
HAND_KERNELS = ("fused_distro_stats_kernel", "segment_sum_kernel")
#: phase 8's loop: its rounds of an agent pass and a tick
LOOP_ROUNDS = 1
#: phase 8, after the loop: quiet ticks of the warm card store with
#: tracing on (True) and off, in an ABBA order so a drift of the host
#: falls on both sides alike
TRACING_ORDER = (True, False, False, True, True, False, False, True)
#: phase 8: the three stores (name, on the card, TickOptions.use_cache),
#: ticked in this order at each step
SERVICE_STORES = (("card warm", True, True), ("CPU warm", False, True),
                  ("card cold", True, False))


def service_tick_inputs(cls):
    """Wrap ``cls.sync`` (the resident plane's) so that each call records
    its plane, arguments and returned snapshot; returns (records, undo)."""
    real = cls.sync
    records = []

    def sync(self, cache, *args, **kwargs):
        snap = real(self, cache, *args, **kwargs)
        records.append((self, args, snap))
        return snap

    cls.sync = sync
    return records, lambda: setattr(cls, "sync", real)


def mirror_matches_truth(np, snap) -> bool:
    """Whether every field of the mirror's resident buffers on the card
    equals the host truth the snapshot's views read."""
    arena = snap.arena
    bufs = {k: v.cpu().numpy() for k, v in arena.buffers.items()}
    offs = {"f32": 0, "i32": 0, "u8": 0}
    for name, kind, size in arena.layout_key():
        off = offs[kind]
        offs[kind] = off + size
        if bufs[kind][off:off + size].tobytes() != np.asarray(arena.view(name)).tobytes():
            return False
    return True


def slab_stats_row(torch, np, snap, cold, sm_mhz) -> dict:
    """``fused_distro_stats`` on the card at a resident tick's slab
    layout: held against the plain version on the CPU (bit for bit) and
    on the card (counts exact, sums within SUM_RTOL), then its device
    time, the plain version's, the seven ``index_add_``s over
    ``t_distro``, and its bound; the chain is the longest distro range
    the offsets give (slab rows, holes and headroom included). ``cold``
    is a cold build of the same tick's gather (the same live tasks on
    the cold layout): the kernel is held and timed on it too, the two
    layouts alternating, so that a gap between them owes to the layout
    and not to the inputs."""
    from evergreen_tpu_torch.ops.distro_stats import (
        fused_distro_stats,
        fused_distro_stats_plain,
    )
    from evergreen_tpu_torch.ops.packing import unpack
    from evergreen_tpu_torch.ops.solve import distro_stats_inputs

    dev = torch.device("cuda", 0)
    a = unpack(snap.arena.buffers, snap.arena.layout_key(), dev)
    args = distro_stats_inputs(a)
    err = hold_distro_stats(torch, args)
    offs = args[5].cpu().numpy().astype(np.int64)
    counts = np.asarray(snap.arrays["d_task_count"]).astype(np.int64)
    D = len(counts)
    longest = int((offs[1:] - offs[:-1]).max())
    n_ranged = int(offs[-1])
    t_distro = a["t_distro"].long()
    dm = a["t_valid"] & a["t_deps_met"]
    th = args[6][t_distro]
    over = dm & (a["t_expected_s"] > th)
    cols = (a["t_valid"].float(), dm.float(), torch.where(dm, a["t_expected_s"], 0.0),
            over.float(), torch.where(over, a["t_expected_s"], 0.0),
            (dm & (a["t_wait_dep_met_s"] > th)).float(), (dm & a["t_is_merge"]).float())

    def seven_index_adds():
        out = torch.zeros((7, D), dtype=torch.float32, device=dev)
        for k, col in enumerate(cols):
            out[k].index_add_(0, t_distro, col)
        return out

    row = dict(
        name="fused_distro_stats[slab]", route="cuda",
        source="evergreen_tpu_torch/csrc/distro_stats.cu",
        replaces="evergreen_tpu/ops/pallas_kernels.py:71", max_abs_err=err,
        **measure(torch, lambda: fused_distro_stats(*args),
                  lambda: fused_distro_stats_plain(*args), seven_index_adds),
        **bounds(bytes_=11 * n_ranged + 4 * (D + 1) + 4 * D + 4 * 7 * D,
                 ops=9 * n_ranged,
                 chain_ms=1e3 * longest * FADD_CYCLES / (sm_mhz * 1e6)),
    )
    log(f"fused_distro_stats on the slab layout: {int(counts.sum())} live tasks in "
        f"{n_ranged} ranged rows of {len(a['t_valid'])}, {D} distros, longest range "
        f"{longest} (the cold layout's would be {int(counts.max())}); bit-equal to "
        f"plain on the CPU; " + fmt_row(row))
    c_args = distro_stats_inputs(unpack(cold.arena.buffers, cold.arena.layout_key(), dev))
    hold_distro_stats(torch, c_args)
    c_offs = c_args[5].cpu().numpy().astype(np.int64)
    c_longest = int((c_offs[1:] - c_offs[:-1]).max())
    check(int(c_offs[-1]) == int(counts.sum()),
          "the cold build of the slab tick ranges other tasks")
    times = {"slab": [row["ms"]], "cold": []}
    for layout in ("cold", "slab", "cold"):
        a_ = c_args if layout == "cold" else args
        times[layout].append(device_ms(torch, lambda: fused_distro_stats(*a_)))
    log(f"fused_distro_stats on the same tick's cold build: {int(c_offs[-1])} ranged "
        f"rows of {len(c_args[0])}, longest range {c_longest} (chain bound "
        f"{1e6 * c_longest * FADD_CYCLES / (sm_mhz * 1e6):.3f} us); device time per "
        f"call, slab / cold alternating: "
        + ", ".join(f"{layout} {1e3 * t:.2f} us" for layout, t in (
            ("slab", times["slab"][0]), ("cold", times["cold"][0]),
            ("slab", times["slab"][1]), ("cold", times["cold"][1]))))
    return row


def service_phase(torch, np, problem, sm_mhz, card="cuda", root=None) -> dict:
    """Phase 8: the service's tick (``TickOptions(use_cache=True)``: the
    TickCache's warm gather and the resident plane, published on the card
    through its device mirror) against the CPU's warm tick and the card's
    cold tick, on three stores; then the loop (``service_loop``). Returns
    the card stores' launches, the loop's, and the slab-layout
    kernels-line row. ``card="cpu"`` rehearses it on the CPU (no
    launches, no kernels-line row, no device profile); ``root`` is where
    the loop's profiler trace goes (``DATA_ROOT`` by default)."""
    import gc
    import itertools
    import random
    import uuid

    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import resident, wrapper
    from evergreen_tpu_torch.scheduler.persister import persister_state_for
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import faults, tracing
    from evergreen_tpu_torch.utils.benchgen import NOW
    from evergreen_tpu_torch.utils.gctune import tune_gc_for_long_lived_heap

    on_card = torch.device(card).type == "cuda"
    distros = problem[0]
    added, removed = distros[-1].id, distros[0].id
    keys = [k for k, _, _ in SERVICE_STORES]
    stores = {k: Store() for k in keys}
    t0 = time.perf_counter()
    for store in stores.values():
        seed_tick_store(store, problem, only={d.id for d in distros[:-1]})
    log(f"service tick: config 3 (seed {SEED}) less {added} in three stores "
        f"({', '.join(keys)}), {time.perf_counter() - t0:.2f} s wall; each step "
        f"ticks them in that order")
    seqs = {k: itertools.count() for k in stores}
    real_uuid4, real_time = uuid.uuid4, time.time
    records, undo = service_tick_inputs(resident.ResidentPlane)

    def distro_churn(store, now):
        tick_churn(store, now)
        seed_tick_store(store, problem, only={added})
        distro_mod.coll(store).remove(removed)

    fault = faults.FaultPlan().always("scheduler.solve", faults.Fault("raise"))
    steps = [
        ("1 (cold prime)", NOW, None, None),
        ("2 (after churn)", NOW + TICK_STEP_S, tick_churn, None),
        ("3 (solve fault)", NOW + 2 * TICK_STEP_S, None, fault),
        (f"4 (+{added}, -{removed}, churn)", NOW + 3 * TICK_STEP_S, distro_churn, None),
        ("5 (quiet)", NOW + 4 * TICK_STEP_S, None, None),
    ]
    total = {k: {} for k in ("card warm", "card cold")}
    trees = {}
    slab_row = None
    try:
        for k, (label, now, before, plan) in enumerate(steps):
            if before is not None:
                for store in stores.values():
                    before(store, now)
            results, shapes, phases, gcs, launches = {}, {}, {}, {}, {}
            del records[:]
            for key, card_store, warm in SERVICE_STORES:
                store = stores[key]
                state = persister_state_for(store)
                shapes0 = [getattr(state, s_) for s_ in SHAPES]
                phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in TICK_PHASES}
                plane = resident.peek_resident_plane(store)
                up0 = plane.stats().get("mirror_bytes_uploaded", 0) if plane else 0
                if k == 0:
                    gc.collect()
                gcs[key] = GcClock()
                gc.callbacks.append(gcs[key])
                if plan is not None:
                    faults.install(plan)
                reset_launches(fused_distro_stats, segment_sum)
                rng = random.Random(2000 + k)
                uuid.uuid4 = lambda rng=rng: uuid.UUID(int=rng.getrandbits(128))
                time.time = lambda now=now: now
                event_mod._SEQ = seqs[key]
                try:
                    results[key] = wrapper.run_tick(
                        store, wrapper.TickOptions(use_cache=warm), now=now,
                        device=card if card_store else "cpu")
                finally:
                    uuid.uuid4, time.time = real_uuid4, real_time
                    gc.callbacks.remove(gcs[key])
                    faults.uninstall()
                launches[key] = read_launches(fused_distro_stats, segment_sum)
                shapes[key] = {s_: getattr(state, s_) - v for s_, v in zip(SHAPES, shapes0)}
                phases[key] = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p]
                               for p in TICK_PHASES}
                if key == "card warm":
                    plane = resident.peek_resident_plane(store)
                    uploaded = plane.stats()["mirror_bytes_uploaded"] - up0
            if k == 0:
                tune_gc_for_long_lived_heap()
            r = results["card warm"]
            solve_tick = plan is None
            want = ("tpu", "") if solve_tick else ("serial", "solve-failed")
            for key in keys:
                c = results[key]
                check((c.planner_used, c.degraded) == want,
                      f"tick {label} {key}: planner {c.planner_used!r}, degraded "
                      f"{c.degraded!r}")
                for field in ("queues", "new_hosts", "n_tasks", "n_distros", "shed",
                              "overload"):
                    check(getattr(c, field) == getattr(r, field),
                          f"tick {label}: TickResult.{field} of {key} differs")
                check([h.to_doc() for h in c.intent_hosts]
                      == [h.to_doc() for h in r.intent_hosts],
                      f"tick {label}: intent hosts of {key} differ")
                check(shapes[key] == shapes["card warm"],
                      f"tick {label}: persister shapes of {key} {shapes[key]} differ "
                      f"from {shapes['card warm']}")
            n_docs = same_service_docs(stores, keys, f"tick {label}")
            check(r.trace_id, f"tick {label}: no trace")
            warm_tree = tree_shape(stores["card warm"], r.trace_id)
            check(warm_tree == tree_shape(stores["CPU warm"],
                                          results["CPU warm"].trace_id, lease=False),
                  f"tick {label}: the card's span tree differs from the CPU's")
            names = tree_names(tree_shape(stores["card cold"],
                                          results["card cold"].trace_id))
            check(names == cold_tree_names(r.degraded),
                  f"tick {label}: the cold store's span tree {names}")
            trees[label] = tree_names(warm_tree)
            cold_l, warm_l = launches["card cold"], launches["card warm"]
            check(warm_l["fused_distro_stats"] == (1 if solve_tick and on_card else 0)
                  and warm_l == cold_l and launches["CPU warm"]["segment_sum"] == 0,
                  f"tick {label}: launches warm {warm_l}, cold {cold_l}")
            for key in total:
                for k_, v in launches[key].items():
                    total[key][k_] = total[key].get(k_, 0) + v
            planes = {key: resident.peek_resident_plane(stores[key])
                      for key in ("card warm", "CPU warm")}
            stats = {key: {s_: v for s_, v in p.stats().items()
                           if not s_.startswith("mirror")}
                     for key, p in planes.items()}
            check(stats["card warm"] == stats["CPU warm"],
                  f"tick {label}: resident counters card {stats['card warm']} != "
                  f"CPU {stats['CPU warm']}")
            check(stats["card warm"]["fallbacks"] == 0, f"tick {label}: resident fallback")
            check(planes["card warm"].device.type == torch.device(card).type
                  and planes["CPU warm"].device.type == "cpu",
                  f"tick {label}: the planes publish on the wrong devices")
            # the card plane's snapshot of this tick: canonical == a cold
            # build of the same gather, and the mirror == the host truth
            mine = [(args, snap) for plane_, args, snap in records
                    if plane_ is planes["card warm"]]
            check(len(mine) == 1, f"tick {label}: {len(mine)} card-plane syncs")
            args, snap = mine[0]
            t1 = time.perf_counter()
            cold = build_snapshot(*args[:5], args[5])
            check(resident.canonicalize(snap) == resident.canonicalize(cold),
                  f"tick {label}: the card plane's snapshot differs from a cold build")
            check(mirror_matches_truth(np, snap),
                  f"tick {label}: the card's mirror differs from the host truth")
            check_ms = (time.perf_counter() - t1) * 1e3
            full = sum(b.numel() * b.element_size() for b in snap.arena.buffers.values())
            if k == 1 and on_card:
                slab_row = slab_stats_row(torch, np, snap, cold, sm_mhz)
            log(f"tick {label}: planner {r.planner_used}, degraded {r.degraded!r}; "
                f"{sum(r.queues.values())} queue items in {len(r.queues)} queues, "
                f"{len(r.intent_hosts)} intents; persister {shapes['card warm']}; "
                f"{n_docs} documents equal in all three stores; launches warm "
                f"{warm_l} == cold; resident {stats['card warm']}; canonical == cold "
                f"build and mirror == truth ({check_ms:.0f} ms to check)")
            log(f"tick {label} wall (ms; " + " / ".join(keys) + "): " + "; ".join(
                f"{p} " + " / ".join(f"{phases[key][p]:.2f}" for key in keys)
                for p in TICK_PHASES)
                + "; whole tick " + " / ".join(f"{results[key].total_ms:.2f}" for key in keys)
                + "; of it in the garbage collector "
                + " / ".join(f"{gcs[key].ms:.2f}" for key in keys)
                + " (" + " / ".join(str(gcs[key].full) for key in keys)
                + " full collections)")
            log(f"tick {label} mirror: {uploaded} B H2D, a full upload of this "
                f"arena {full} B ({100.0 * uploaded / full:.1f}%)")
    finally:
        undo()
    log(f"service tick span trees (card warm == CPU warm less arena_lease; card cold "
        f"its cold tree): " + "; ".join(f"{k} {v}" for k, v in trees.items()))
    loop = service_loop(torch, np, stores, keys, seqs, card, root or DATA_ROOT)
    last_trace = tracing_cost(stores["card warm"], card)
    dispatch_parenting(stores["card warm"], last_trace)
    return dict(launches=total, loop=loop, slab_row=slab_row)


def tracing_cost(store, card) -> str:
    """Tracing's cost on the quiet tick: after the loop, quiet ticks of the
    warm card store in ``TRACING_ORDER``; prints the median whole tick
    with tracing on and off, and the median of the differences of the
    adjacent on/off pairs. Reported, not gated (the JAX package's guard
    holds on-vs-off to 2%, ``tools/perf_guard.py``). Returns the last
    traced tick's trace id."""
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.utils import tracing
    from evergreen_tpu_torch.utils.benchgen import NOW

    walls = {True: [], False: []}
    pairs = []
    last = None
    for i, on in enumerate(TRACING_ORDER):
        traced = tracing.set_tracing_enabled(on)
        try:
            res = wrapper.run_tick(store, wrapper.TickOptions(use_cache=True),
                                   now=NOW + (10 + i) * TICK_STEP_S, device=card)
        finally:
            tracing.set_tracing_enabled(traced)
        check((res.planner_used, res.degraded) == ("tpu", ""),
              f"tracing cost tick {i}: planner {res.planner_used!r}, degraded "
              f"{res.degraded!r}")
        check(bool(res.trace_id) == on, f"tracing cost tick {i}: trace {res.trace_id!r}")
        last = res.trace_id or last
        walls[on].append(res.total_ms)
        if i % 2:
            pairs.append(walls[True][-1] - walls[False][-1])
    on_ms, off_ms = statistics.median(walls[True]), statistics.median(walls[False])
    log(f"tracing cost, card warm store, {len(TRACING_ORDER)} quiet ticks in the order "
        + "".join("+" if on else "-" for on in TRACING_ORDER)
        + f": whole tick median on {on_ms:.2f} ms, off {off_ms:.2f} ms "
        f"({100.0 * (on_ms - off_ms) / off_ms:+.1f}%); on-off pairs "
        + ", ".join(f"{d:+.2f}" for d in pairs)
        + f" ms, median {statistics.median(pairs):+.2f} ms; ticks on "
        + ", ".join(f"{w:.2f}" for w in walls[True]) + "; off "
        + ", ".join(f"{w:.2f}" for w in walls[False])
        + " (not gated; the JAX package's guard holds on-vs-off to 2%, "
        "tools/perf_guard.py)")
    return last


#: the pulls after tracing's cost whose spans must parent into the last tick
PARENTED_PULLS = 8


def dispatch_parenting(store, trace_id) -> None:
    """After tracing's cost, the first ``PARENTED_PULLS`` tasks in flight
    on the warm card store finish (``mark_task_started``, ``mark_end``) and
    their hosts pull again: the pulls' ``dispatch_assign`` spans parent
    into the last traced tick's trace (``tracing.trace_tree``). (The
    loop's second pass, which checked the same of the profiled tick, was
    cut to make room for phase 13.)"""
    from evergreen_tpu_torch.dispatch.assign import assign_next_available_task
    from evergreen_tpu_torch.dispatch.dag_dispatcher import DispatcherService
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models.lifecycle import mark_end, mark_task_started
    from evergreen_tpu_torch.utils import tracing

    in_flight = sorted((d["_id"], d["host_id"]) for d in store.collection("tasks").find(
        lambda d: d["status"] in ("dispatched", "started")))[:PARENTED_PULLS]
    check(len(in_flight) == PARENTED_PULLS, f"dispatch parenting: {len(in_flight)} tasks "
          f"in flight")
    for tid, _ in in_flight:
        mark_task_started(store, tid)
        mark_end(store, tid, "success")
    svc = DispatcherService(store)
    got = [assign_next_available_task(store, svc, host_mod.get(store, hid))
           for _, hid in in_flight]
    tree = tracing.trace_tree(store, trace_id)
    assigns = [c for c in tree["roots"][0]["children"] if c["name"] == "dispatch_assign"]
    check(len(assigns) == PARENTED_PULLS
          and all(c["component"] == "dispatch" for c in assigns),
          f"dispatch parenting: {len(assigns)} dispatch_assign spans in the last tick's "
          f"trace after {len(got)} pulls")
    log(f"dispatch parenting: {PARENTED_PULLS} tasks finished after the last traced "
        f"tick, their hosts pulled again ({sum(t is not None for t in got)} assigned); "
        f"the {len(assigns)} dispatch_assign spans parent into that tick's trace")


def infos_by_name(doc) -> dict:
    """A queue document with its task-group infos sorted by name. After
    dispatch starts task groups on hosts, a warm store's resident plane
    orders those host-only (empty) groups otherwise than a cold build,
    and so does the JAX package's: the warm and cold documents then
    differ in that order alone (ROADMAP, Queue 3)."""
    info = doc.get("info")
    if not isinstance(info, dict) or "task_group_infos" not in info:
        return doc
    return dict(doc, info=dict(info, task_group_infos=sorted(
        info["task_group_infos"], key=lambda g: g["name"])))


def same_service_docs(stores, keys, label) -> int:
    """Every document of ``TICK_COLLECTIONS`` equal across ``stores`` (in
    ``keys`` order, held to the first; the cold store's queue documents
    with their task-group infos in name order, ``infos_by_name``), and
    the span documents of the two warm stores equal (``span_json``; the
    cold store's spans are held by their trees); returns how many
    documents were compared."""
    n_docs = 0
    for name in TICK_COLLECTIONS:
        want_docs = stores[keys[0]].collection(name).find()
        for key in keys[1:]:
            got = stores[key].collection(name).find()
            check(len(got) == len(want_docs), f"{label}: {name} count of {key} differs")
            for g, w in zip(got, want_docs):
                if key == "card cold" and g != w:
                    g, w = infos_by_name(g), infos_by_name(w)
                check(g == w, f"{label}: {name} document {w.get('_id')!r} of {key} "
                      f"differs from {keys[0]}'s")
        n_docs += len(want_docs)
    check(span_json(stores["card warm"]) == span_json(stores["CPU warm"]),
          f"{label}: the span documents of the warm stores differ")
    return n_docs + len(stores["card warm"].collection("spans"))


def service_loop(torch, np, stores, keys, seqs, card, root) -> dict:
    """Phase 8's loop on its three stores: ``LOOP_ROUNDS`` rounds of an
    agent pass (``agent_pass``: what a fleet worker's ``agent_sim`` does)
    and a tick (two until phase 13 needed the time).
    After each pass the (host, task) pairs, then every document, equal
    across the stores; after each tick the documents, the queues and
    ``TickResult.new_hosts`` too, and the launches exact. The first loop
    tick of the warm card store runs its solve under the device profiler
    (``TracerConfig.xla_profile_dir``, set in every store: the next tick,
    the CPU store's, writes no second trace): the trace names both
    kernels, and their device time fits in the tick's ``solve`` span; that
    tick's span tree equals the CPU store's. Returns the card stores'
    launches in the loop's ticks."""
    import random
    import shutil
    import uuid

    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.settings import CapacityConfig, TracerConfig
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    profile_dir = os.path.join(root, "loop-profile")
    shutil.rmtree(profile_dir, ignore_errors=True)
    real_uuid4, real_time = uuid.uuid4, time.time
    want = (expected_launches([CapacityConfig().iterations]) if on_card
            else {"fused_distro_stats": 0, "segment_sum": 0})
    loop = {"card warm": {}, "card cold": {}}
    for j in range(LOOP_ROUNDS):
        t_pass = NOW + (6 + 2 * j) * TICK_STEP_S
        t_tick = t_pass + TICK_STEP_S
        passes = {}
        for key in keys:
            event_mod._SEQ = seqs[key]
            time.time = lambda t_pass=t_pass: t_pass
            try:
                passes[key] = agent_pass(stores[key], t_pass)
            finally:
                time.time = real_time
        finished, pairs, _, _ = passes[keys[0]]
        for key in keys[1:]:
            check(passes[key][:2] == (finished, pairs),
                  f"loop pass {j + 1}: {key}'s finished tasks or (host, task) pairs differ")
        n_docs = same_service_docs(stores, keys, f"loop pass {j + 1}")
        n_assigned = sum(1 for _, t in pairs if t is not None)
        check(n_assigned > 0, f"loop pass {j + 1}: nothing dispatched")
        log(f"loop pass {j + 1}: {len(finished)} tasks finished (mark_end), "
            f"{len(pairs)} free hosts pulled, {n_assigned} assigned; pairs and "
            f"{n_docs} documents equal in the three stores; dispatch wall (ms; "
            + " / ".join(keys) + "): " + " / ".join(f"{passes[k][2]:.2f}" for k in keys)
            + "; assigns per second " + " / ".join(
                f"{1e3 * n_assigned / max(passes[k][2], 1e-9):.0f}" for k in keys)
            + "; mark_task_started + mark_end wall (ms) " + " / ".join(
                f"{passes[k][3]:.2f}" for k in keys))
        if j == 0:
            for store in stores.values():
                TracerConfig(xla_profile_dir=profile_dir).set(store)
        results, launches, phases = {}, {}, {}
        for key, card_store, warm in SERVICE_STORES:
            phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in TICK_PHASES}
            reset_launches(fused_distro_stats, segment_sum)
            rng = random.Random(4000 + j)
            uuid.uuid4 = lambda rng=rng: uuid.UUID(int=rng.getrandbits(128))
            time.time = lambda t_tick=t_tick: t_tick
            event_mod._SEQ = seqs[key]
            try:
                results[key] = wrapper.run_tick(
                    stores[key], wrapper.TickOptions(use_cache=warm), now=t_tick,
                    device=card if card_store else "cpu")
            finally:
                uuid.uuid4, time.time = real_uuid4, real_time
            launches[key] = read_launches(fused_distro_stats, segment_sum)
            phases[key] = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p]
                           for p in TICK_PHASES}
            if j == 0 and key == "card warm" and on_card:
                profiled_solve_checks(stores[key], results[key], profile_dir)
            if j == 0 and key != "card warm" and on_card:
                check(len(os.listdir(profile_dir)) == 1,
                      f"loop tick 1: {key}'s tick wrote a second trace")
        r = results["card warm"]
        for key in keys:
            c = results[key]
            check((c.planner_used, c.degraded) == ("tpu", ""),
                  f"loop tick {j + 1} {key}: planner {c.planner_used!r}, degraded "
                  f"{c.degraded!r}")
            for field in ("queues", "new_hosts", "n_tasks", "n_distros", "shed",
                          "overload"):
                check(getattr(c, field) == getattr(r, field),
                      f"loop tick {j + 1}: TickResult.{field} of {key} differs")
            if key != "CPU warm":
                check(launches[key] == want, f"loop tick {j + 1} {key}: launches "
                      f"{launches[key]}, expected {want}")
                for k_, v in launches[key].items():
                    loop[key][k_] = loop[key].get(k_, 0) + v
        n_docs = same_service_docs(stores, keys, f"loop tick {j + 1}")
        check(tree_shape(stores["card warm"], r.trace_id) == tree_shape(
            stores["CPU warm"], results["CPU warm"].trace_id, lease=False),
            f"loop tick {j + 1}: the card's span tree differs from the CPU's")
        log(f"loop tick {j + 1}: planner {r.planner_used}, degraded {r.degraded!r}; "
            f"{sum(r.queues.values())} queue items, {sum(r.new_hosts.values())} new "
            f"hosts; {n_docs} documents equal in the three stores; launches {want} "
            f"in each card store (exact)")
        log(f"loop tick {j + 1} wall (ms; " + " / ".join(keys) + "): " + "; ".join(
            f"{p} " + " / ".join(f"{phases[key][p]:.2f}" for key in keys)
            for p in TICK_PHASES)
            + "; whole tick " + " / ".join(f"{results[key].total_ms:.2f}" for key in keys))
    shutil.rmtree(profile_dir, ignore_errors=True)
    return loop


def profiled_solve_checks(store, res, profile_dir) -> None:
    """The loop's profiled tick: its Chrome trace exists and names both
    kernels, and their device time (every kernel event of the capture,
    which covers the solve only) is at most the tick's ``solve`` span."""
    from evergreen_tpu_torch.utils import tracing

    files = os.listdir(profile_dir)
    check(files == [os.path.basename(tracing.profile_trace_path(profile_dir))],
          f"loop tick 1: profile directory holds {files}")
    with open(os.path.join(profile_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    for k in HAND_KERNELS:
        check(any(k in n for n in names), f"loop tick 1: the trace names no {k}")
    device_ms = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    tree = tracing.trace_tree(store, res.trace_id)
    solve = next(c for c in tree["roots"][0]["children"] if c["name"] == "solve")
    check(device_ms <= solve["duration_ms"],
          f"loop tick 1: kernels' device time {device_ms:.3f} ms exceeds the solve "
          f"span's {solve['duration_ms']:.3f} ms")
    by_name = {}
    for e in kernels:
        short = next((k for k in HAND_KERNELS if k in e["name"]), "other")
        by_name[short] = by_name.get(short, 0) + 1
    log(f"loop tick 1 (card warm) under the device profiler: trace "
        f"{os.path.getsize(os.path.join(profile_dir, files[0]))} B, "
        f"{len(kernels)} kernels ({json.dumps(by_name, sort_keys=True)}), their device "
        f"time {device_ms:.3f} ms inside the solve span's {solve['duration_ms']:.3f} ms "
        f"(the tick {res.total_ms:.2f} ms)")


#: phase 9: the sharded plane's shard count, its three planes (name, the
#: plane's device, its stacking rule), the collections compared after
#: each round and the round whose shard 0 is held at YELLOW
PLANE_SHARDS = 4
PLANES = (("a", "cuda", "always"), ("b", "cuda", "auto"), ("c", "cpu", "never"))
PLANE_COLLECTIONS = ("distros",) + TICK_COLLECTIONS + ("shard_handoffs",)
PLANE_ROUNDS = ("1 (prime)", "2 (after churn)", "3 (shard 0 YELLOW)",
                "4 (after the handoff, profiled)")
YELLOW_ROUND = 2
PROFILED_ROUND = 3
#: the plane that round runs under torch.profiler: the stacked one (plane
#: (b)'s local round under it was cut to make room for phase 13)
PROFILED_PLANE = "a"
#: plane (a)'s modes: round 1 measures the shards' common dims (local);
#: round 2 stacks, or is local only where round 1's intents grew some
#: shard's dims past that floor ("grown"); every later round stacks
PLANE_A_MODES = ("local", "stacked or grown", "stacked", "stacked")


def canon_doc(doc):
    """``doc``, or a copy with the ids that depend on how the shard
    threads interleave canonicalised: an event's id, an intent host's id
    (its distro kept) and secret, and those inside handoff payloads."""
    if is_span(doc):
        return canon_span(doc)
    if doc["_id"].startswith("evt-"):
        return dict(doc, _id="evt")
    if doc["_id"].startswith("evg-") and doc.get("status") == "initializing":
        return dict(doc, _id=doc["_id"].rsplit("-", 1)[0], secret="")
    if "payload" in doc:
        return dict(doc, payload={c: [canon_doc(d) for d in ds]
                                  for c, ds in doc["payload"].items()})
    return doc


def same_plane_docs(planes, label) -> int:
    """Check every shard store's documents equal across ``planes``
    (name -> plane), ids canonicalised; returns how many were compared."""
    names = list(planes)
    n = 0
    for k in range(PLANE_SHARDS):
        for coll in PLANE_COLLECTIONS:
            want = [canon_doc(d) for d in planes[names[0]].stores[k].collection(coll).find()]
            for name in names[1:]:
                got = planes[name].stores[k].collection(coll).find()
                check(len(got) == len(want), f"{label}: shard {k} {coll} count of "
                      f"plane {name} differs from plane {names[0]}'s")
                for g, w in zip(got, want):
                    check(canon_doc(g) == w, f"{label}: shard {k} {coll} document "
                          f"{w['_id']!r} of plane {name} differs from plane {names[0]}'s")
            n += len(want)
    return n


def make_planes(problem, specs, opts, card):
    """One plane per (name, device, stacked) of ``specs`` over
    ``PLANE_SHARDS`` shard stores, each split by ``seed_partition`` from
    its own store of config 3 with phase 6's capacity settings (which
    every shard store gets too)."""
    from evergreen_tpu_torch.scheduler.sharded_plane import ShardedScheduler
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store

    planes = {}
    for name, device, stacked in specs:
        src = Store()
        seed_tick_store(src, problem)
        plane = planes[name] = ShardedScheduler.build(
            PLANE_SHARDS, device=card if device == "cuda" else "cpu",
            stacked=stacked, tick_opts=opts, rebalance_enabled=True)
        plane.seed_partition(src)
        for s in plane.stores:
            CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET).set(s)
    return planes


def timed_stacked_solve(plane):
    """Wrap ``plane._stacked_solve``; returns a list of (ms, drift) per
    call: drift is None when the shards' padded dims agreed, else (the
    floor they were built at, their padded dims in shard order)."""
    calls = []
    real = plane._stacked_solve

    def solve(snaps):
        floor = plane._common_dims
        keys = [snaps[k].shape_key() for k in sorted(snaps)]
        t0 = time.perf_counter()
        try:
            out = real(snaps)
        except ValueError:
            calls.append(((time.perf_counter() - t0) * 1e3, (floor, keys)))
            raise
        calls.append(((time.perf_counter() - t0) * 1e3, None))
        return out

    plane._stacked_solve = solve
    return calls


def grown_past_floor(floor, keys) -> bool:
    """Whether a drift is the one the floor allows: every shard built at
    or above the floor on every axis, and some shard above it."""
    if floor is None:
        return True  # no floor yet: the first round's natural dims
    names = ("N", "M", "U", "G", "H", "D")
    return (all(k[i] >= floor[n] for k in keys for i, n in enumerate(names))
            and any(k[i] > floor[n] for k in keys for i, n in enumerate(names)))


def plane_doc_diff(a, b, limit=4) -> str:
    """Where two planes' shards hold different documents (canonical form,
    as ``canon_doc``): per collection and shard, the count only in each
    and an example of each, or that the order alone differs; for a failed
    equality check's message."""
    from collections import Counter

    out = []
    for k, (sa, sb) in enumerate(zip(a.stores, b.stores)):
        for c in PLANE_COLLECTIONS:
            la, lb = ([json.dumps(canon_doc(d), sort_keys=True, default=str)
                       for d in s_.collection(c).find()] for s_ in (sa, sb))
            if la == lb:
                continue
            only_a = list((Counter(la) - Counter(lb)).elements())
            only_b = list((Counter(lb) - Counter(la)).elements())
            if not only_a and not only_b:
                out.append(f"{c}[{k}]: the same documents in another order")
            else:
                out.append(f"{c}[{k}]: {len(only_a)} only in the first "
                           f"({only_a[0][:400] if only_a else ''}), {len(only_b)} only in "
                           f"the second ({only_b[0][:400] if only_b else ''})")
            if len(out) >= limit:
                return "; ".join(out)
    return "; ".join(out) or "none differs"


def check_plane_a_mode(r, label, mode, drift, modes=PLANE_A_MODES) -> None:
    """Hold a stacking card plane's mode in round ``r`` to ``modes``
    (phase 9's plane (a): ``PLANE_A_MODES``; phase 10's durable fleet:
    ``FLEET_MODES``)."""
    want = modes[r]
    if want == "stacked or grown" and drift:
        ok = mode == "local" and all(grown_past_floor(f, k) for f, k in drift)
    else:
        ok = mode == want.split()[0] and (not drift or want == "local")
    check(ok, f"round {label}: {mode}, expected {want} (stacked solve drift {drift})")


def profiled_tick(torch, plane, now) -> tuple:
    """One round of ``plane`` under torch.profiler: its result, and the
    round's wall, the device's busy time (every kernel, copy and memset),
    its idle share of the wall, and the host's time in CUDA
    synchronisation calls summed over the shard threads and at most in
    one thread, with the count of kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = plane.tick(now=now)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, sync_us, sync_by_thread, n_launch = 0.0, 0.0, {}, 0
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            busy_us += us
        elif e.name.endswith("Synchronize"):
            sync_us += us
            sync_by_thread[e.thread] = sync_by_thread.get(e.thread, 0.0) + us
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            n_launch += 1
    check(busy_us > 0, "the profiled round saw no device time")
    return res, dict(
        wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / wall_us, sync_ms=sync_us / 1e3,
        sync_max_thread_ms=max(sync_by_thread.values(), default=0.0) / 1e3,
        kernel_launches=n_launch)


def fleet_pull(planes, now) -> None:
    """After phase 9's last round: an agent pull for every free host, in
    id order across the shards, through
    ``assign_next_available_task_fleet`` on plane (a) (card) and plane
    (c) (CPU); the pairs, and every shard store's documents, equal."""
    from evergreen_tpu_torch.dispatch.assign import assign_next_available_task_fleet

    pulls, ms = {}, {}
    for name in ("a", "c"):
        plane = planes[name]
        hids = sorted(d["_id"] for s in plane.stores for d in s.collection("hosts").find()
                      if d["status"] == "running" and d["started_by"] == "mci"
                      and not d["running_task"])
        t0 = time.perf_counter()
        pulls[name] = []
        for hid in hids:
            t = assign_next_available_task_fleet(plane, hid, now=now)
            pulls[name].append((hid, t.id if t is not None else None))
        ms[name] = (time.perf_counter() - t0) * 1e3
    check(pulls["a"] == pulls["c"], "fleet pull: the (host, task) pairs of (a) and (c) "
          "differ")
    n_assigned = sum(1 for _, t in pulls["a"] if t is not None)
    check(n_assigned > 0, "fleet pull: nothing dispatched")
    n_docs = same_plane_docs({k: planes[k] for k in ("a", "c")}, "fleet pull")
    log(f"fleet pull: {len(pulls['a'])} free hosts pulled through "
        f"assign_next_available_task_fleet, {n_assigned} assigned; pairs and {n_docs} "
        f"documents equal in (a) and (c); wall ms (a) {ms['a']:.2f}, (c) {ms['c']:.2f}; "
        f"assigns per second (a) {1e3 * n_assigned / ms['a']:.0f}, (c) "
        f"{1e3 * n_assigned / ms['c']:.0f}")


def sharded_phase(torch, np, problem, card="cuda", after_profile=None) -> dict:
    """Phase 9: the sharded plane at config 3 over four shard stores on
    one card, in three planes ticked round by round; ``after_profile()``
    is called once round ``PROFILED_ROUND`` (profiled on the card) is
    done. Returns the card planes' launches. ``card="cpu"`` rehearses it
    on the CPU."""
    from evergreen_tpu_torch.ops import distro_stats
    from evergreen_tpu_torch.ops._build import KernelError
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import resident, sharded_plane, wrapper
    from evergreen_tpu_torch.scheduler.sharded_plane import (
        SHARD_TICK_MS,
        fleet_owner_violations,
        merge_fleet_state,
    )
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import overload
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    t0 = time.perf_counter()
    planes = make_planes(problem, PLANES, wrapper.TickOptions(use_cache=True), card)
    counts = [s.collection("distros").count() for s in planes["a"].stores]
    log(f"sharded plane: config 3 (seed {SEED}) split over {PLANE_SHARDS} shard stores "
        f"({counts} distros), three planes: " + ", ".join(
            f"({n}) {d} stacked={st!r}" for n, d, st in PLANES)
        + f"; {time.perf_counter() - t0:.2f} s wall to seed them")
    stacked_calls = timed_stacked_solve(planes["a"])
    iters = CapacityConfig().iterations
    real_time = time.time
    total = {name: {} for name, device, _ in PLANES if device == "cuda"}
    a_modes = []
    try:
        for r, label in enumerate(PLANE_ROUNDS):
            now = NOW + r * TICK_STEP_S
            if r == 1:
                for plane in planes.values():
                    for s in plane.stores:
                        tick_churn(s, now)
            for plane in planes.values():
                overload.monitor_for(plane.stores[0]).set_floor(
                    overload.YELLOW if r == YELLOW_ROUND else overload.GREEN)
            res, launches, shard_ms, phases, mirror, full = {}, {}, {}, {}, 0, 1
            traced = {}
            n_calls = len(stacked_calls)
            for name, plane in planes.items():
                shard0 = [SHARD_TICK_MS.state(shard=k)[1] for k in range(PLANE_SHARDS)]
                phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in TICK_PHASES}
                up0 = sum(resident.peek_resident_plane(s).stats().get("mirror_bytes_uploaded", 0)
                          for s in plane.stores if resident.peek_resident_plane(s))
                reset_launches(fused_distro_stats, segment_sum)
                time.time = lambda: now
                try:
                    if r == PROFILED_ROUND and on_card and name == PROFILED_PLANE:
                        res[name], traced[name] = profiled_tick(torch, plane, now)
                    else:
                        res[name] = plane.tick(now=now)
                finally:
                    time.time = real_time
                launches[name] = read_launches(fused_distro_stats, segment_sum)
                shard_ms[name] = [SHARD_TICK_MS.state(shard=k)[1] - shard0[k]
                                  for k in range(PLANE_SHARDS)]
                phases[name] = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p]
                                for p in TICK_PHASES}
                if name == "b":
                    rplanes = [resident.peek_resident_plane(s) for s in plane.stores]
                    mirror = sum(p_.stats().get("mirror_bytes_uploaded", 0)
                                 for p_ in rplanes) - up0
                    full = sum(b.nbytes for p_ in rplanes
                               for b in p_._truth.buffers.values())
            drift = [d for _, d in stacked_calls[n_calls:] if d is not None]
            solve_ms = [ms for ms, d in stacked_calls[n_calls:] if d is None]
            n_docs = same_plane_docs(planes, f"round {label}")
            # spans: the two local planes' equal (span_json); plane (a)'s
            # stacked rounds pack fresh, so its spans are held by count
            for k in range(PLANE_SHARDS):
                check(span_json(planes["b"].stores[k]) == span_json(planes["c"].stores[k]),
                      f"round {label}: shard {k}'s span documents differ in (b) and (c)")
                ticks = planes["a"].stores[k].collection("spans").count(
                    lambda d: d["name"] == "tick")
                check(ticks == r + 1, f"round {label}: plane (a) shard {k} holds {ticks} "
                      f"tick spans")
            for name, plane in planes.items():
                check(fleet_owner_violations(plane.stores) == [],
                      f"round {label}: plane {name} violates exactly-one-owner")
                check(not res[name].degraded, f"round {label}: plane {name} degraded "
                      f"{res[name].degraded}")
                check(res[name].migrations == res["a"].migrations,
                      f"round {label}: plane {name}'s migrations differ from (a)'s")
                check(res[name].fleet_level == res["a"].fleet_level,
                      f"round {label}: plane {name}'s fleet level differs")
            modes = {name: res[name].solve_mode for name in planes}
            check_plane_a_mode(r, label, modes["a"], drift)
            check(modes["b"] == modes["c"] == "local", f"round {label}: modes {modes}")
            a_modes.append(modes["a"])
            check((r == YELLOW_ROUND) == bool(res["a"].migrations),
                  f"round {label}: migrations {res['a'].migrations}")
            for name, plane in planes.items():
                blocks = sum(1 for x in res[name].results.values() if x.planner_used == "tpu")
                check(blocks == PLANE_SHARDS, f"round {label}: plane {name} solved "
                      f"{blocks} blocks")
                on = on_card and dict((n, d) for n, d, _ in PLANES)[name] == "cuda"
                want = (expected_launches([iters] * blocks) if on
                        else {"fused_distro_stats": 0, "segment_sum": 0})
                check(launches[name] == want, f"round {label}: plane {name} launches "
                      f"{launches[name]}, expected {want}")
                if name in total:
                    for k_, v in launches[name].items():
                        total[name][k_] = total[name].get(k_, 0) + v
            log(f"sharded round {label}: modes " + ", ".join(
                f"({n}) {m}" for n, m in modes.items())
                + f" (stacked solve drift {drift}); migrations "
                + json.dumps([{k: m[k] for k in ("_id", "group", "from", "to")}
                              for m in res["a"].migrations])
                + f"; fleet {res['a'].fleet_level}; {res['a'].n_tasks} tasks, "
                f"{sum(len(x.intent_hosts) for x in res['a'].results.values())} intents; "
                f"{n_docs} documents equal in the three planes; launches per plane "
                + json.dumps({n: launches[n]['fused_distro_stats'] for n in planes})
                + " fused_distro_stats (exact)")
            log(f"sharded round {label} wall (ms, " + " / ".join(planes) + "): round "
                + " / ".join(f"{res[n].total_ms:.2f}" for n in planes)
                + "; shard ticks " + " / ".join(
                    "[" + ", ".join(f"{v:.2f}" for v in shard_ms[n]) + "]" for n in planes)
                + "; phases summed over shards: " + "; ".join(
                    f"{p} " + " / ".join(f"{phases[n][p]:.2f}" for n in planes)
                    for p in TICK_PHASES)
                + "; stacked solve " + (", ".join(f"{ms:.2f}" for ms in solve_ms)
                                        if solve_ms else "none")
                + f"; plane (b) mirror {mirror} B H2D, a full upload of its four "
                f"arenas {full} B ({100.0 * mirror / full:.1f}%)")
            for name, t in traced.items():
                log(f"sharded round {label} plane ({name}) under torch.profiler: "
                    f"wall {t['wall_ms']:.2f} ms, device busy {t['busy_ms']:.2f} ms "
                    f"(idle share {100 * t['idle_share']:.1f}%), host in CUDA "
                    f"synchronisation {t['sync_ms']:.2f} ms summed over the shard "
                    f"threads ({t['sync_max_thread_ms']:.2f} ms in the most waiting "
                    f"one), {t['kernel_launches']} kernel launches")
            if r == PROFILED_ROUND and after_profile is not None:
                after_profile()
        fleet_pull(planes, NOW + len(PLANE_ROUNDS) * TICK_STEP_S)
    finally:
        time.time = real_time
        for plane in planes.values():
            plane.close()
    del planes
    log(f"sharded plane (a) modes {a_modes}; required {list(PLANE_A_MODES)}")

    # the merged queues of a stacked plane equal a single store's tick
    # (no intents: the fleet budget split is the plane's own), then a
    # failed launch inside its stacked solve raises out of the round
    opts = wrapper.TickOptions(use_cache=True, create_intent_hosts=False)
    planes = make_planes(problem, (("a", "cuda", "always"),), opts, card)
    plane = planes["a"]
    single = Store()
    seed_tick_store(single, problem)
    oracle_modes = []
    try:
        for r in range(2):
            now = NOW + r * TICK_STEP_S
            reset_launches(fused_distro_stats, segment_sum)
            oracle_modes.append(plane.tick(now=now).solve_mode)
            got = read_launches(fused_distro_stats, segment_sum)
            check(got == (expected_launches([0] * PLANE_SHARDS) if on_card else
                          {"fused_distro_stats": 0, "segment_sum": 0}),
                  f"oracle round {r + 1}: launches {got}")
            wrapper.run_tick(single, wrapper.TickOptions(create_intent_hosts=False),
                             now=now, device=card)
            merged = merge_fleet_state(plane.stores)
            for coll in ("task_queues", "task_secondary_queues"):
                want = sorted(single.collection(coll).find(), key=lambda d: d["_id"])
                got_q = sorted(merged.collection(coll).find(), key=lambda d: d["_id"])
                check(got_q == want, f"oracle round {r + 1}: merged {coll} differ from "
                      f"the single store's")
        check(oracle_modes == ["local", "stacked"], f"oracle modes {oracle_modes}")
        local = []
        real_local = sharded_plane.run_solve_packed
        real_launch = distro_stats._launch_fn
        sharded_plane.run_solve_packed = lambda *a, **k: local.append(1) or real_local(*a, **k)
        distro_stats._launch_fn = lambda: (lambda *args: 719)
        raised = None
        try:
            plane.tick(now=NOW + 2 * TICK_STEP_S)
        except KernelError as exc:
            raised = exc
        finally:
            sharded_plane.run_solve_packed = real_local
            distro_stats._launch_fn = real_launch
        if on_card:
            check(raised is not None and local == [],
                  f"a failed launch in the stacked solve: raised {raised!r}, "
                  f"{len(local)} local solves")
    finally:
        plane.close()
    log(f"sharded oracle: a fresh plane (a) without intents, rounds {oracle_modes}, "
        f"merged queues == a single store's card tick after each; a failed launch "
        f"in its stacked solve raised {raised!r} out of tick() with no local solve")
    return total


#: phase 10: the service's tick as ``units/crons.py`` runs it, on durable
#: stores. The stores (name, on the card, durable), ticked in this order
#: at each step: (a) durable on the card, (b) durable on the CPU, (c) the
#: in-memory card store of phase 8, the control
DURABLE_STORES = (("a", True, True), ("b", False, True), ("c", True, False))
#: the writer leases' TTL, and where the data directories live (inside
#: the checkout, gitignored, removed at the end of the phase)
LEASE_TTL_S = 2.0
DATA_ROOT = os.path.join(HERE, "_smoke_data")
#: readings one phase keeps for a later one to print beside its own
READINGS = {}
#: the fleet's rounds (shard 0 held YELLOW for a handoff in the second
#: until phase 13 needed the time, and the round between the churn and
#: that one until phase 8's loop did: phase 9 runs the in-process plane's
#: handoff, and phase 11 durable shards' stacked rounds and handoff)
FLEET_ROUNDS = ("1 (prime)", "2 (after churn)", "3 (quiet)")
#: the durable card fleet's modes, held as phase 9 holds plane (a)'s:
#: round 1 measures the floor (local); round 2 stacks or meets a shard
#: the churn grew past it (local, the floor raised); round 3 stacks: the
#: stacked solve over durable shards, its WAL groups beside the stacked
#: barrier
FLEET_MODES = ("local", "stacked or grown", "stacked")


def wal_path(store) -> str:
    return store._journal.path


def wal_lines(path, start=0) -> list:
    """The WAL's terminated lines from byte ``start`` on."""
    with open(path, "rb") as fh:
        fh.seek(start)
        return [line for line in fh.read().split(b"\n") if line]


def lease_span_record(rec: dict) -> bool:
    """Whether ``rec`` journals an ``arena_lease`` span (a CPU publish's;
    the card's publish through the mirror leases no arena)."""
    return rec.get("c") == "spans" and rec.get("d", {}).get("name") == "arena_lease"


def canon_record(rec: dict) -> dict:
    """A WAL record without its commit time and stamp (the flusher writes
    a frame whenever its thread runs), documents as ``canon_doc`` (span
    documents masked), a frame without its ``arena_lease`` span records
    (``n`` counting the rest)."""
    rec = {k: v for k, v in rec.items() if k not in ("ts", "k")}
    if "rs" in rec:
        rec["rs"] = [canon_record(r) for r in rec["rs"] if not lease_span_record(r)]
        rec["n"] = len(rec["rs"])
    if "d" in rec:
        rec["d"] = canon_doc(rec["d"])
    if "ds" in rec:
        rec["ds"] = [canon_doc(d) for d in rec["ds"]]
    return rec


#: the fields a queue document's write stamps (``generated_at``, the
#: version ``v``): a store whose persister is fresh (reopened after a
#: crash, or a new lease holder's) rewrites every queue document once,
#: where a live store skips the unchanged ones
QUEUE_STAMPS = ("generated_at", "v")


def store_json(store, names=None, stamps=True) -> str:
    """Every collection (or ``names``) of ``store`` as canonical JSON: a
    recovered store holds the JSON of the live one (a queue row is a
    tuple in memory and a list after replay). ``stamps=False`` leaves
    out the queue documents' ``QUEUE_STAMPS``."""
    if names is None:  # every collection that holds a document
        names = [n for n in sorted(store._collections) if len(store.collection(n))]

    def docs(n):
        found = store.collection(n).find()
        if stamps or n not in ("task_queues", "task_secondary_queues"):
            return found
        return [{k: v for k, v in d.items() if k not in QUEUE_STAMPS} for d in found]

    return json.dumps({n: docs(n) for n in names},
                      sort_keys=True, separators=(",", ":"), default=str)


def doc_names(store) -> list:
    """The collections of ``store`` that hold a document, but ``spans``."""
    return [n for n in sorted(store._collections)
            if n != "spans" and len(store.collection(n))]


def timed_method(store, name) -> list:
    """Wrap ``store``'s method ``name`` (``sync_persist``: the tick's
    persist barrier; ``commit_group_inline``: a frame's write on the
    flusher thread); returns the list each call appends its wall ms to."""
    real = getattr(store, name)
    ms = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            ms.append((time.perf_counter() - t0) * 1e3)

    setattr(store, name, timed)
    return ms


def wait_flushed(store) -> float:
    """Wait until ``store``'s flusher is idle without taking its deferred
    errors (the next tick's barrier does); returns the ms waited."""
    t0 = time.perf_counter()
    while store.flush_backlog():
        time.sleep(0.001)
    return (time.perf_counter() - t0) * 1e3


def durable_phase(torch, np, problem, card="cuda", root=DATA_ROOT) -> dict:
    """Phase 10: the service's tick (``units/crons.py::service_tick_options``)
    on durable stores — the WAL group commit on the flusher, replay after
    a crash, the epoch fence — and the durable sharded
    fleet. Returns the
    card's launches by store. ``card="cpu"`` rehearses it on the CPU."""
    import gc
    import itertools
    import random
    import shutil
    import uuid

    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import resident, wrapper
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage import durable
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.lease import FileLease
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.units.crons import service_tick_options
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    opts = service_tick_options()
    phases = TICK_PHASES + ("wal_commit",)
    iters = CapacityConfig().iterations
    solve_launches = (expected_launches([iters]) if on_card
                      else {"fused_distro_stats": 0, "segment_sum": 0})
    no_launches = {"fused_distro_stats": 0, "segment_sum": 0}
    distros = problem[0]
    keep = {d.id for d in distros[:-1]}
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: os.path.join(root, k) for k in ("a", "b")}
    leases, stores, seed_ms = {}, {}, {}
    for key, on, is_durable in DURABLE_STORES:
        t0 = time.perf_counter()
        if is_durable:
            lease = leases[key] = FileLease(os.path.join(dirs[key], "writer.lease"),
                                            ttl_s=LEASE_TTL_S)
            check(lease.try_acquire(), f"store ({key}): lease not acquired")
            lease.start_renewing()
            stores[key] = DurableStore(dirs[key], lease=lease)
        else:
            stores[key] = Store()
        seed_tick_store(stores[key], problem, only=keep)
        seed_ms[key] = (time.perf_counter() - t0) * 1e3
    devices = {k: (card if on else "cpu") for k, on, _ in DURABLE_STORES}
    # the store reopened later: (a)'s crash copy on the card
    devices.update({"replayed": card})
    log(f"durable tick: config 3 (seed {SEED}) less {distros[-1].id} in (a) a DurableStore "
        f"on the card, (b) one on the CPU, (c) the in-memory card store; leases "
        f"{LEASE_TTL_S} s, renewing; seeding ms (a) {seed_ms['a']:.1f}, (b) "
        f"{seed_ms['b']:.1f}, (c) {seed_ms['c']:.1f}; WAL bytes (a) "
        f"{os.path.getsize(wal_path(stores['a']))}, (b) "
        f"{os.path.getsize(wal_path(stores['b']))}")
    barriers, writes = {}, {}

    def watch(key, store):
        """Time ``store``'s barriers and frame writes under ``key``."""
        barriers[key] = timed_method(store, "sync_persist")
        writes[key] = timed_method(store, "commit_group_inline")

    for key in ("a", "b"):
        watch(key, stores[key])
    seqs = {k: itertools.count() for k in stores}
    real_uuid4, real_time = uuid.uuid4, time.time
    launches_by = {"a": {}, "c": {}, "replayed": {}}

    def add(key, got):
        for k_, v in got.items():
            launches_by[key][k_] = launches_by[key].get(k_, 0) + v

    def tick(key, store, k, now, device):
        """One tick of ``store``; the k-th tick of every store draws the
        same uuid4 stream, reads the same clock and continues the event
        sequence of ``key``. Returns (result, launches, phases, gc ms)."""
        phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in phases}
        clock = GcClock()
        gc.callbacks.append(clock)
        reset_launches(fused_distro_stats, segment_sum)
        rng = random.Random(3000 + k)
        uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128))
        time.time = lambda: now
        event_mod._SEQ = seqs[key]
        try:
            res = wrapper.run_tick(store, opts, now=now, device=device)
        finally:
            uuid.uuid4, time.time = real_uuid4, real_time
            gc.callbacks.remove(clock)
        got = read_launches(fused_distro_stats, segment_sum)
        ph = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p] for p in phases}
        return res, got, ph, clock.ms

    def mirror_bytes(store):
        plane = resident.peek_resident_plane(store)
        stats = plane.stats() if plane is not None else {}
        full = (sum(b.nbytes for b in plane._truth.buffers.values())
                if plane is not None and plane._truth is not None else 0)
        return stats.get("mirror_bytes_uploaded", 0), full

    def same_docs(keyed, label, fresh=()):
        """Every document of ``TICK_COLLECTIONS`` equal across the stores
        of ``keyed`` (name -> store), as canonical JSON. A store whose persister is
        fresh (``fresh``: reopened after a crash, or a new lease holder's)
        rewrites the queue documents that a live store's tick skips: the
        fresh stores are held to each other with every field, and to the
        live ones without the queue documents' ``QUEUE_STAMPS``. Returns
        the count of documents and of queue documents whose stamps differ
        between the first fresh store and the first live one."""
        full = {k: store_json(s, TICK_COLLECTIONS) for k, s in keyed.items()}
        spans = {k: span_json(s) for k, s in keyed.items()}
        for group in ([k for k in keyed if k not in fresh], [k for k in keyed if k in fresh]):
            for k in group[1:]:
                check(full[k] == full[group[0]],
                      f"{label}: the documents of {k} differ from {group[0]}'s")
                check(spans[k] == spans[group[0]],
                      f"{label}: the span documents of {k} differ from {group[0]}'s")
        n_docs = sum(len(next(iter(keyed.values())).collection(n)) for n in TICK_COLLECTIONS)
        if not fresh:
            return n_docs, 0
        live = next(k for k in keyed if k not in fresh)
        bare = {k: store_json(keyed[k], TICK_COLLECTIONS, stamps=False)
                for k in (live,) + tuple(fresh)}
        for k in fresh:
            check(bare[k] == bare[live], f"{label}: the documents of {k} differ from "
                  f"{live}'s beyond the queue documents' {QUEUE_STAMPS}")
            check(span_json(keyed[k], live=False) == span_json(keyed[live], live=False),
                  f"{label}: the span documents of {k} differ from {live}'s beyond "
                  f"{FRESH_ATTRS}")
        restamped = sum(
            1 for n in ("task_queues", "task_secondary_queues")
            for d, e in zip(keyed[fresh[0]].collection(n).find(),
                            keyed[live].collection(n).find())
            if any(d.get(f) != e.get(f) for f in QUEUE_STAMPS))
        return n_docs, restamped

    def report(label, step):
        for key, (res, ph, gc_ms, extra, up) in step.items():
            mirror = (f"; mirror {up[0]} B H2D of a full {up[1]} B "
                      f"({100.0 * up[0] / max(1, up[1]):.1f}%)" if up[1] else "")
            log(f"durable tick {label} ({key}) ms: " + "; ".join(
                f"{p} {ph[p]:.2f}" for p in phases)
                + f"; whole tick {res.total_ms:.2f}; collector {gc_ms:.2f}" + extra
                + mirror)

    def durable_extra(key, store, start):
        """The WAL side of a durable store's tick, once its frame is
        written: bytes appended, the frame's write on the flusher, what
        the check waited for it, and the barrier at the tick's start (the
        previous frame's)."""
        waited = wait_flushed(store)
        wal0, n_writes, n_barriers = start
        new_w = writes[key][n_writes:]
        new_b = barriers[key][n_barriers:]
        return (f"; WAL +{os.path.getsize(wal_path(store)) - wal0} B; frame "
                f"write on the flusher " + ", ".join(f"{w:.2f}" for w in new_w)
                + f" (still running when checked: {waited:.2f} ms); barrier at this "
                f"tick's start " + (f"{new_b[0]:.3f}" if new_b else "none"))

    def tick_checked(key, store, k, now, label, step, starts):
        """The k-th tick of ``store`` on ``devices[key]``, held to a clean
        solve (planner tpu, not degraded) and a solve tick's launches; its
        report line goes into ``step`` and, for a durable store, what its
        WAL side is measured from into ``starts``. Returns the result."""
        dev = devices[key]
        if key in writes:
            starts[key] = (os.path.getsize(wal_path(store)), len(writes[key]),
                           len(barriers[key]))
        up0 = mirror_bytes(store)[0]
        res, got, ph, gc_ms = tick(key, store, k, now, dev)
        up = mirror_bytes(store)
        step[key] = [res, ph, gc_ms, "", (up[0] - up0, up[1])]
        check((res.planner_used, res.degraded) == ("tpu", ""),
              f"tick {label} ({key}): planner {res.planner_used!r}, degraded "
              f"{res.degraded!r}")
        want = solve_launches if dev != "cpu" else no_launches
        check(got == want, f"tick {label} ({key}): launches {got}, expected {want}")
        if key in launches_by:
            add(key, got)
        return res

    def wal_side(keyed, step, starts, label, pairs):
        """Each durable store's WAL side of the step, once its frame is
        written, into its report line; each store's records of the step
        held to one group frame, and those of each pair in ``pairs``
        equal (canonical)."""
        frames = {}
        for key, start in starts.items():
            step[key][3] = durable_extra(key, keyed[key], start)
            recs = [json.loads(x) for x in wal_lines(wal_path(keyed[key]), start[0])]
            n_frames = sum(1 for x in recs if x["o"] == "g")
            check(n_frames == 1, f"tick {label} ({key}): {n_frames} group frames")
            frames[key] = [canon_record(x) for x in recs]
        for x, y in pairs:
            check(frames[x] == frames[y], f"tick {label}: the WAL records of ({x}) and "
                  f"({y}) differ")
        return frames

    def crash_copy(key, src):
        """A copy of ``src`` as a SIGKILL leaves it (the store not closed;
        a lease's tmp file, which its renewer may be renaming, left out)."""
        dst = os.path.join(root, key)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.lease.*"))
        return dst

    def replay(key, path, lease=None):
        """``DurableStore(path)`` as ``key``, its barriers and frame writes
        timed; returns the open's ms."""
        t0 = time.perf_counter()
        stores[key] = DurableStore(path, lease=lease)
        ms = (time.perf_counter() - t0) * 1e3
        watch(key, stores[key])
        return ms

    # (a quiet tick after the churn was cut to make room for phase 13:
    # phase 12's cron rounds tick durable card stores again and again)
    steps = [("1 (prime)", NOW, None), ("2 (after churn)", NOW + TICK_STEP_S, tick_churn)]
    try:
        for k, (label, now, before) in enumerate(steps):
            if before is not None:
                for store in stores.values():
                    before(store, now)
            step, starts = {}, {}
            results = {key: tick_checked(key, stores[key], k, now, label, step, starts)
                       for key in ("a", "b", "c")}
            r = results["a"]
            for key in ("b", "c"):
                for field in ("queues", "new_hosts", "n_tasks", "n_distros", "shed"):
                    check(getattr(results[key], field) == getattr(r, field),
                          f"tick {label}: TickResult.{field} of ({key}) differs from (a)'s")
            n_docs, _ = same_docs(stores, f"tick {label}")
            frames = wal_side(stores, step, starts, label, [("a", "b")])
            if k:
                READINGS["durable churn tick ms"] = r.total_ms
            log(f"durable tick {label}: planner tpu in all three; {sum(r.queues.values())} "
                f"queue items in {len(r.queues)} queues, {len(r.intent_hosts)} intents; "
                f"{n_docs} documents equal in (a), (b), (c); one group frame a durable "
                f"store, records (a) == (b) ({len(frames['a'])} lines); launches "
                f"{solve_launches['fused_distro_stats']} + {solve_launches['segment_sum']} "
                f"in (a) and (c), 0 in (b)")
            report(label, step)

        # ---- crash after tick 2's barrier, and replay ------------------- #
        # (a)'s copy reopens on the card (a copy of (b) reopened on the CPU,
        # its comparator with every field, was cut when phase 13 needed the
        # time: it is held to the live stores without the queue stamps)
        for key in ("a", "b"):
            stores[key].sync_persist()
        replay_ms = replay("replayed", crash_copy("a-crashed", dirs["a"]))
        replayed = stores["replayed"]
        check(store_json(replayed) == store_json(stores["a"]),
              "the replayed copy differs from (a)")
        log(f"durable crash: (a) copied after tick 2's barrier without closing; "
            f"DurableStore(copy of (a)) replayed in {replay_ms:.2f} ms "
            f"({os.path.getsize(wal_path(replayed))} WAL bytes, report "
            f"{replayed.replay_report}); every document equal to the original's")
        n = next(seqs["a"])
        seqs["a"], seqs["replayed"] = itertools.count(n), itertools.count(n)
        label, now = "3 (after churn)", NOW + 2 * TICK_STEP_S
        tick4 = {k: stores[k] for k in ("a", "b", "c", "replayed")}
        for store in tick4.values():
            tick_churn(store, now)
        step, starts = {}, {}
        for key, store in tick4.items():
            tick_checked(key, store, 2, now, label, step, starts)
        wal_side(tick4, step, starts, label, [("a", "b")])
        n_docs, restamped = same_docs(tick4, f"tick {label}", fresh=("replayed",))
        plane = resident.peek_resident_plane(replayed)
        check(plane.rebuild_reasons == {"cold": 1},
              f"the replayed store's plane rebuilt {plane.rebuild_reasons}")
        if on_card:
            up, full = step["replayed"][4]
            check(up == full, f"the replayed store's mirror uploaded {up} of {full} B")
        log(f"durable tick {label}: {n_docs} documents equal in (a), (b), (c) and the "
            f"replayed copy, every field in (a), (b), (c); between the copy and the live "
            f"stores {restamped} queue documents differ in {QUEUE_STAMPS} alone (the "
            f"copy's fresh persister rewrote what the live stores skipped); the copy's "
            f"plane a cold build, its mirror a full upload")
        report(label, step)

        # (a copy of (a) with tick 3's frame torn, reopened to the documents
        # before that tick, was cut when phase 13 needed the time: the
        # store's host code; tests/test_torch_durable.py tears every offset)
        for key in ("a", "b"):
            stores[key].sync_persist()
        stores.pop("replayed")._journal.close()

        # ---- the fence: a thief takes (a)'s lease ---------------------- #
        leases["a"].stop_renewing()
        time.sleep(LEASE_TTL_S + 0.2)
        thieves = {"thief": FileLease(leases["a"].path, ttl_s=LEASE_TTL_S)}
        for key, owner in (("thief", "a"),):
            lease = thieves[key]
            check(lease.try_acquire() and lease.epoch == leases[owner].epoch + 1,
                  f"{key} did not take the lease (epoch {lease.epoch})")
        label, now = "4 (fenced)", NOW + 3 * TICK_STEP_S
        wal0 = os.path.getsize(wal_path(stores["a"]))
        docs0 = store_json(stores["a"], names=doc_names(stores["a"]))
        spans0 = {d["_id"] for d in stores["a"].collection("spans").find()}
        res, got, ph, gc_ms = tick("a", stores["a"], 3, now, card)
        plane = resident.peek_resident_plane(stores["a"])
        check(res.degraded == "fenced" and res.queues == {} and res.planner_used == "",
              f"tick {label} (a): degraded {res.degraded!r}")
        check(got == no_launches, f"tick {label} (a): launches {got}")
        check(os.path.getsize(wal_path(stores["a"])) == wal0, f"tick {label}: (a)'s WAL grew")
        check(store_json(stores["a"], names=doc_names(stores["a"])) == docs0,
              f"tick {label}: (a)'s documents changed")
        # the fenced tick's root span reaches memory (the store applies a
        # write before its journal refuses it, as the JAX package's does)
        # and never the WAL (the size check above)
        new_spans = [(d["name"], d["attributes"]["degraded"])
                     for d in stores["a"].collection("spans").find() if d["_id"] not in spans0]
        check(new_spans == [("tick", "fenced")],
              f"tick {label}: (a)'s new span documents {new_spans}")
        check(not plane._ready and plane._pending_reason == "fenced"
              and (plane._mirror is None or plane._mirror._bufs is None),
              f"tick {label}: (a)'s plane was not dropped ({plane._pending_reason!r})")
        log(f"durable tick {label} (a): degraded 'fenced' in {res.total_ms:.2f} ms, no "
            f"launch, WAL {wal0} B unchanged, documents unchanged, plane invalidated "
            f"'fenced' (mirror buffers dropped); thief epoch {thieves['thief'].epoch} "
            f"(the thief's own open and tick on (a)'s directory were cut when phase 13 "
            f"needed the time: phase 11's restarted worker takes its lease over so)")
        stores["b"].sync_persist()
        t0 = time.perf_counter()
        stores["b"].checkpoint()
        ck_ms = (time.perf_counter() - t0) * 1e3
        snap = os.path.join(dirs["b"], durable.SNAPSHOT_FILE)
        log(f"durable checkpoint ((b)'s store): {ck_ms:.2f} ms, snapshot "
            f"{os.path.getsize(snap)} B")
        thieves["thief"].release()
        stores["a"].close()
        stores["b"].close()
        leases["b"].release()
        check(not os.path.exists(leases["b"].path), "(b)'s lease file remains")
    finally:
        uuid.uuid4, time.time = real_uuid4, real_time
        for lease in leases.values():
            lease.stop_renewing()
    del stores
    shutil.rmtree(root, ignore_errors=True)
    return launches_by


def fleet_phase(torch, np, problem, keep, card, data_dir, launches_by) -> None:
    """Phase 10's durable fleet: ``ShardedScheduler.build(4, data_dir=...,
    stacked="always")`` on the card against an in-memory CPU plane
    (``stacked="never"``), the cron front end's round options; three rounds,
    a crash copy and ``open_fleet``, the reopened fleet's documents equal
    to the live card fleet's. A fourth round on the reopened fleet was cut
    when phase 13 needed the time, and a second copy reopened on the CPU
    when phase 11 did."""
    import shutil

    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.sharded_plane import (
        ShardedScheduler,
        fleet_owner_violations,
        open_fleet,
    )
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.units.crons import service_tick_options
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    opts = service_tick_options()
    iters = CapacityConfig().iterations
    kw = dict(tick_opts=wrapper.TickOptions(use_cache=True), rebalance_enabled=True)
    t0 = time.perf_counter()
    planes = {
        "card": ShardedScheduler.build(PLANE_SHARDS, data_dir=data_dir,
                                       lease_ttl_s=LEASE_TTL_S, device=card,
                                       stacked="always", **kw),
        "cpu": ShardedScheduler.build(PLANE_SHARDS, device="cpu", stacked="never", **kw),
    }
    build_ms = (time.perf_counter() - t0) * 1e3
    for plane in planes.values():
        src = Store()
        seed_tick_store(src, problem, only=keep)
        for s in plane.stores:  # each durable shard's seed is one group frame
            s.begin_tick()
        plane.seed_partition(src)
        for s in plane.stores:
            CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET).set(s)
            s.end_tick()
    log(f"durable fleet: {PLANE_SHARDS} DurableStores in one directory (build "
        f"{build_ms:.2f} ms, leases {LEASE_TTL_S} s), stacked='always' on the card, "
        f"against an in-memory CPU plane, stacked='never'; rounds with the cron "
        f"front end's options; seeded by seed_partition")
    real_time = time.time
    stacked_calls = {"card": timed_stacked_solve(planes["card"])}
    reopened = {}
    copies = [data_dir + "-crashed"]

    def plane_docs(plane, stamps):
        return json.dumps([[
            [canon_doc(d) if stamps or c not in ("task_queues", "task_secondary_queues")
             else {k: v for k, v in canon_doc(d).items() if k not in QUEUE_STAMPS}
             for d in s.collection(c).find()] for c in PLANE_COLLECTIONS]
            for s in plane.stores], sort_keys=True, default=str)

    def run_round(label, r, now, keyed, fresh=()):
        """One round of every plane of ``keyed``; the card plane's mode held
        to ``FLEET_MODES``; documents equal across the planes, with every
        field within the live planes and within the ``fresh`` ones (fresh
        persisters), and without the queue documents' ``QUEUE_STAMPS``
        between the two."""
        res, launches, drift = {}, {}, []
        for name, plane in keyed.items():
            n_calls = len(stacked_calls.get(name, ()))
            reset_launches(fused_distro_stats, segment_sum)
            time.time = lambda: now
            try:
                res[name] = plane.tick(now=now, opts=opts)
            finally:
                time.time = real_time
            launches[name] = read_launches(fused_distro_stats, segment_sum)
            if name in stacked_calls:
                drift = [d for _, d in stacked_calls[name][n_calls:] if d is not None]
                check_plane_a_mode(r, f"{label} ({name})", res[name].solve_mode, drift,
                                   modes=FLEET_MODES)
        full = {}
        for name, plane in keyed.items():
            check(fleet_owner_violations(plane.stores) == [],
                  f"fleet round {label}: {name} violates exactly-one-owner")
            check(not res[name].degraded, f"fleet round {label}: {name} degraded "
                  f"{res[name].degraded}")
            blocks = sum(1 for x in res[name].results.values() if x.planner_used == "tpu")
            check(blocks == PLANE_SHARDS, f"fleet round {label}: {name} solved {blocks}")
            dev = plane.device.type
            want = (expected_launches([iters] * blocks) if dev == "cuda" and on_card
                    else {"fused_distro_stats": 0, "segment_sum": 0})
            check(launches[name] == want, f"fleet round {label}: {name} launches "
                  f"{launches[name]}, expected {want}")
            if dev == "cuda":
                for k_, v in launches[name].items():
                    launches_by["fleet"][k_] = launches_by["fleet"].get(k_, 0) + v
            full[name] = plane_docs(plane, stamps=True)
        names = list(keyed)
        for group in ([n for n in names if n not in fresh], [n for n in names if n in fresh]):
            for name in group[1:]:
                if full[name] != full[group[0]]:
                    raise AssertionError(
                        f"fleet round {label}: the documents of {name} differ from "
                        f"{group[0]}'s: " + plane_doc_diff(keyed[name], keyed[group[0]])
                        + "; shards (overload, shed, degraded): " + json.dumps(
                            {n: {k: [x.overload, list(x.shed), x.degraded]
                                 for k, x in sorted(res[n].results.items())}
                             for n in (name, group[0])}, default=str))
        if fresh:
            bare = {n: plane_docs(keyed[n], stamps=False) for n in names}
            for name in names[1:]:
                check(bare[name] == bare[names[0]], f"fleet round {label}: the documents "
                      f"of {name} differ from {names[0]}'s beyond {QUEUE_STAMPS}")
        for name in names[1:]:
            check(res[name].migrations == res[names[0]].migrations,
                  f"fleet round {label}: migrations differ")
        # spans: the card fleet's stacked rounds pack fresh where the CPU
        # plane's local rounds pack through the resident plane, so the
        # planes' spans are held by their tick counts, shard by shard
        ticks = {n: [s.collection("spans").count(lambda d: d["name"] == "tick")
                     for s in keyed[n].stores] for n in names}
        for name in names[1:]:
            check(ticks[name] == ticks[names[0]], f"fleet round {label}: tick spans "
                  f"{ticks}")
        log(f"durable fleet round {label}: modes " + ", ".join(
            f"{n} {res[n].solve_mode}" for n in names) + f" (card drift {drift}); wall ms "
            + ", ".join(f"{n} {res[n].total_ms:.2f}" for n in names) + f"; migrations "
            + json.dumps([{k: m[k] for k in ("_id", "group", "from", "to")}
                          for m in res[names[0]].migrations])
            + "; documents equal" + (f" (every field between {'/'.join(fresh)}, whose "
                                      f"persisters are fresh; {QUEUE_STAMPS} aside "
                                      f"against the rest)" if fresh else "")
            + "; launches per plane "
            + json.dumps({n: launches[n]["fused_distro_stats"] for n in names})
            + "; shard ticks (ms, overload, shed) " + json.dumps(
                {n: [[round(x.total_ms, 1), x.overload, list(x.shed)]
                     for _, x in sorted(res[n].results.items())] for n in names},
                default=str))
        return res

    try:
        for r, label in enumerate(FLEET_ROUNDS):
            now = NOW + r * TICK_STEP_S
            if r == 1:
                for plane in planes.values():
                    for s in plane.stores:
                        tick_churn(s, now)
            res = run_round(label, r, now, planes)
            check(not res["card"].migrations,
                  f"fleet round {label}: migrations {res['card'].migrations}")
        for s in planes["card"].stores:
            s.sync_persist()
        # a lease's tmp file may be renamed under the copy
        shutil.copytree(data_dir, copies[0], ignore=shutil.ignore_patterns("*.lease.*"))
        t0 = time.perf_counter()
        reopened["reopened"] = open_fleet(copies[0], PLANE_SHARDS, lease_ttl_s=LEASE_TTL_S,
                                          device=card, stacked="always", **kw)
        open_ms = (time.perf_counter() - t0) * 1e3
        check(plane_docs(reopened["reopened"], stamps=True)
              == plane_docs(planes["card"], stamps=True),
              "durable fleet: the reopened copy's documents differ from the card fleet's")
        log(f"durable fleet: the directory copied after round {len(FLEET_ROUNDS)} "
            f"without closing; "
            f"open_fleet(copy) in {open_ms:.2f} ms on the card (stale leases stolen, "
            f"epochs {[s.epoch for s in reopened['reopened'].stores]}, handoffs "
            f"reconciled); every shard's documents equal to the live card fleet's (its "
            f"round on the reopened fleet was cut when phase 13 needed the time)")
    finally:
        time.time = real_time
        for plane in (planes["card"], *reopened.values(), planes["cpu"]):
            plane.close()
    left = [f for d in [data_dir] + copies if os.path.isdir(d)
            for f in os.listdir(d) if f.endswith(".lease")]
    check(left == [], f"durable fleet: lease files left after close(): {left}")
    log("durable fleet: the two durable fleets closed, every shard lease released")


# ---- the operator's surface (phases 11-13) --------------------------------- #

#: the relative tolerance the operator routes' floats (solve provenance,
#: capacity decomposition) are held to between the card and the CPU
ROUTE_RTOL = 2e-6
#: what a ``fleet_state`` read twice cannot agree on: the last round's wall
#: ms is set by the round, but a heartbeat's deadline moves with the clock
FLEET_TIME_KEYS = ("last_round_ms", "heartbeat_overdue")


class LocalSink:
    """A local HTTP server standing in for the event plane's outside
    world: it records every POST (path, lower-cased headers, body) and
    answers a GET with ``files[path]`` (the GitHub contents API's raw
    form) or 404."""

    def __init__(self, files=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sink = self
        self.posts, self.gets, self.files = [], [], dict(files or {})
        self.lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                with sink.lock:
                    sink.posts.append((self.path, {k.lower(): v for k, v in
                                                   self.headers.items()}, body))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")

            def do_GET(self):
                text = sink.files.get(self.path)
                with sink.lock:
                    sink.gets.append(self.path)
                self.send_response(404 if text is None else 200)
                self.end_headers()
                self.wfile.write((text or "").encode())

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def http_text(base, path) -> tuple:
    """One GET of ``base + path``: (status, content type, text)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def parse_exposition(text) -> dict:
    """Prometheus text v0.0.4 into {(name, labels): value}; fails on a
    malformed line, a sample without its ``# TYPE``, and a histogram
    whose buckets are not cumulative or whose ``+Inf`` bucket is not its
    ``_count``."""
    import re

    sample = re.compile(r'^([a-z_][a-z0-9_]*)(\{[^}]*\})? (-?[0-9.e+]+|[+-]Inf)$')
    types, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
            continue
        m = sample.match(line)
        check(m is not None, f"/metrics: malformed line {line!r}")
        name, labels = m.group(1), m.group(2) or ""
        check(name in types or re.sub(r"_(bucket|sum|count)$", "", name) in types,
              f"/metrics: {name} has no # TYPE")
        out[(name, labels)] = float(m.group(3))
    for (name, labels), value in out.items():
        if not name.endswith("_count") or types.get(name[:-6]) != "histogram":
            continue
        inner = labels[1:-1]
        counts = [v for (n, ls), v in out.items() if n == name[:-6] + "_bucket"
                  and re.sub(r',?le="[^"]*"', "", ls[1:-1]) == inner]
        check(counts == sorted(counts) and counts[-1] == value,
              f"/metrics: {name}{labels} buckets {counts}, count {value}")
    return out


def series(samples, name, **labels) -> float:
    """One series' value (0 when absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return samples.get((name, "{" + want + "}" if want else ""), 0.0)


def series_sum(samples, name) -> float:
    """The sum over a counter's or a ``_count``'s series."""
    return sum(v for (n, _), v in samples.items() if n == name)


def close_route_docs(got, want, path="") -> None:
    """Two route documents equal: integers, strings, booleans and ranks
    exactly, floats within ``ROUTE_RTOL`` (or the unit a provenance
    ``fractional`` is rounded to)."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want), f"{path}: keys differ")
        for k in want:
            close_route_docs(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{path}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            close_route_docs(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        unit = FRACTIONAL_UNIT * (1 + 1e-6) if path.endswith(".fractional") else 0.0
        check(isinstance(got, float) and abs(got - want) <= max(ROUTE_RTOL * abs(want), unit),
              f"{path}: {got!r} != {want!r}")
    else:
        check(type(got) is type(want) and got == want, f"{path}: {got!r} != {want!r}")


def masked_fleet(state) -> dict:
    """``fleet_state`` through JSON, ``FLEET_TIME_KEYS`` masked."""
    doc = json.loads(json.dumps(state))
    for w in doc["workers"].values():
        for k in FLEET_TIME_KEYS:
            w.pop(k, None)
    return doc


def fleet_reads(base, sup, served, prev, label) -> dict:
    """After a phase 11 round, over HTTP against the supervisor's front:
    ``GET /rest/v2/admin/fleet`` equals ``fleet_state()`` (times masked),
    and ``GET /metrics`` parses, its stacked-round counter and round-time
    histogram count grown by exactly the round's stacked serves since
    ``prev`` (the last scrape's samples). Returns this scrape's."""
    t0 = time.perf_counter()
    st, doc = http_json(base, "GET", "/rest/v2/admin/fleet")
    fleet_ms = (time.perf_counter() - t0) * 1e3
    check(st == 200 and masked_fleet(doc) == masked_fleet(sup.fleet_state()),
          f"process fleet round {label}: admin/fleet answered {st}, not fleet_state()")
    t0 = time.perf_counter()
    st, ctype, text = http_text(base, "/metrics")
    metrics_ms = (time.perf_counter() - t0) * 1e3
    check(st == 200 and ctype == "text/plain; version=0.0.4; charset=utf-8",
          f"process fleet round {label}: /metrics answered {st} {ctype}")
    now = parse_exposition(text)
    stacked = sum(1 for x in served if x["outcome"] == "stacked")
    moved = {n: series(now, n, outcome="stacked") - series(prev, n, outcome="stacked")
             for n in ("scheduler_fleet_solver_rounds_total",
                       "scheduler_fleet_solver_round_ms_count")}
    served_all = (series_sum(now, "scheduler_fleet_solver_rounds_total")
                  - series_sum(prev, "scheduler_fleet_solver_rounds_total"))
    check(all(v == stacked for v in moved.values()) and served_all == len(served),
          f"process fleet round {label}: /metrics moved {moved} and {served_all} rounds in "
          f"all; {stacked} stacked of {len(served)} serves")
    log(f"process fleet round {label} over HTTP: admin/fleet = fleet_state() "
        f"({doc['rounds']} rounds, solver rounds {doc['solver_rounds']}) in {fleet_ms:.1f} ms; "
        f"/metrics ({len(text)} bytes, {len(now)} samples) in {metrics_ms:.1f} ms, the "
        f"stacked rounds counter and round-time count each +{stacked}")
    return now


# ---- phase 11: the process-per-shard fleet -------------------------------- #

PROC_SHARDS = 4
#: the fleet's rounds: prime, two quiet rounds, the round after a handoff
#: and, after shard 2 is drained, killed and restarted, two more
PROC_ROUNDS = ("1 (prime)", "2 (quiet)", "3 (quiet)", "4 (after the handoff)",
               "5 (after the restart)", "6 (after the agent pass)")
#: the handoff lands before this round (0-based); shard 2 is killed after it
PROC_MIGRATE, PROC_KILL_AFTER, PROC_KILLED = 3, 3, 2
#: every worker's harness agent (``agent_sim``) runs after this round
PROC_AGENT_AFTER = 4
#: the leader's modes: round 1 measures the floor (local); round 2 stacks
#: or meets a shard whose intents grew it past the floor; the round after
#: the handoff stacks or meets the target grown past the floor; the rest
#: stack
PROC_MODES = ("local", "stacked or grown", "stacked", "stacked or grown", "stacked",
              "stacked")
#: the supervisor's recovery anchor: the boot's recovery pass runs at it,
#: a restart's at it plus the rounds done times the supervisor's TICK_S
PROC_ANCHOR = 1_750_000_000.0 - 15.0
#: tasks the seeded churn leaves in flight, per shard: on hosts whose
#: heartbeat is stale at the anchor, on hosts that are gone, on a
#: terminated host; and mock hosts left building
PROC_STALE, PROC_GONE, PROC_BUILDING = 3, 2, 3


def proc_round_now(r) -> float:
    return PROC_ANCHOR + (r + 1) * TICK_STEP_S


def proc_agent_now() -> float:
    return proc_round_now(PROC_AGENT_AFTER) + 1.0


def seed_proc_fleet(problem, data_dir) -> dict:
    """Config 3 with phase 6's capacity settings (each shard's quota and
    intent budget a quarter of the fleet's), split over ``PROC_SHARDS``
    shard segments at epoch 0 (no lease: the workers' writes land after
    these), then a churn written without a lease: benchgen's phantom
    ``running_task`` stamps stay (recovery step 1), some tasks are left in
    flight on hosts that cannot be running them (step 2) and some mock
    hosts building (step 3)."""
    from evergreen_tpu_torch.scheduler.sharded_plane import ShardedScheduler
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.store import Store

    src = Store()
    seed_tick_store(src, problem)
    stores = [DurableStore(data_dir, shard_id=k) for k in range(PROC_SHARDS)]
    for s in stores:  # each segment's seed is one group frame, as JAX seeds
        s.begin_tick()
    plane = ShardedScheduler(stores, device="cpu", stacked="never")
    plane.seed_partition(src)
    quota = {p: q // PROC_SHARDS for p, q in PLAN_QUOTA.items()}
    stale = PROC_ANCHOR - 3600.0
    for k, s in enumerate(stores):
        CapacityConfig(pool_quotas=quota,
                       fleet_intent_budget=PLAN_BUDGET // PROC_SHARDS).set(s)
        tasks, hosts = s.collection("tasks"), s.collection("hosts")
        runnable = sorted(d["_id"] for d in tasks.find()
                          if d["status"] == "undispatched" and d["activated"])
        free = sorted(d["_id"] for d in hosts.find()
                      if d["status"] == "running" and not d["running_task"])
        n = PROC_STALE + PROC_GONE + 1
        picked, on_hosts = runnable[:n], free[:PROC_STALE + 1]
        for tid, hid in zip(picked[:PROC_STALE], on_hosts):
            tasks.update(tid, {"status": "started", "host_id": hid, "dispatch_time": stale,
                               "start_time": stale, "last_heartbeat": stale})
            hosts.update(hid, {"running_task": tid})
        for j, tid in enumerate(picked[PROC_STALE:PROC_STALE + PROC_GONE]):
            tasks.update(tid, {"status": "dispatched", "host_id": f"gone-{k}-{j}",
                               "dispatch_time": PROC_ANCHOR - 60.0,
                               "last_heartbeat": PROC_ANCHOR - 60.0})
        down = on_hosts[PROC_STALE]
        hosts.update(down, {"status": "terminated", "termination_time": stale})
        tasks.update(picked[-1], {"status": "started", "host_id": down,
                                  "dispatch_time": PROC_ANCHOR - 60.0,
                                  "start_time": PROC_ANCHOR - 60.0,
                                  "last_heartbeat": PROC_ANCHOR - 60.0})
        building = free[PROC_STALE + 1:PROC_STALE + 1 + PROC_BUILDING]
        for j, hid in enumerate(building):
            hosts.update(hid, {"status": "building",
                               "external_id": f"mock-{hid}" if j == 0 else ""})
        s.end_tick()
    plane.close()  # each segment's checkpoint; no lease to release


def proc_migration(data_dir) -> tuple:
    """The handoff of ``PROC_MIGRATE``: shard 0's first distro by id that
    is its own affinity group, to shard 1, with its ``now``; read off the
    seeded segments, so the twin knows it before the fleet runs."""
    from evergreen_tpu_torch.parallel.topology import ShardTopology
    from evergreen_tpu_torch.storage.durable import DurableStore

    s = DurableStore(data_dir, shard_id=0)
    s._journal.close()  # inspection: never close() a segment we do not own
    topo = ShardTopology(PROC_SHARDS)
    topo.affinity = ShardTopology.affinity_from_store(s)
    ids = sorted(d["_id"] for d in s.collection("distros").find())
    distro = next(d for d in ids if sum(topo.placement_key(x) == topo.placement_key(d)
                                        for x in ids) == 1)
    return distro, 0, 1, proc_round_now(PROC_MIGRATE) - 1.0


def proc_canon(doc):
    """``canon_doc``, and an intent's creation time, which the clock of the
    process that made it stamps."""
    if "payload" in doc:
        return dict(doc, payload={c: [proc_canon(d) for d in ds]
                                  for c, ds in doc["payload"].items()})
    intent = doc["_id"].startswith("evg-") and doc.get("status") == "initializing"
    doc = canon_doc(doc)
    return dict(doc, creation_time=0.0) if intent else doc


def proc_docs(store) -> str:
    """Every collection of ``store`` that holds a document, canonical."""
    names = [n for n in sorted(store._collections) if len(store.collection(n))]
    return json.dumps({n: [proc_canon(d) for d in store.collection(n).find()]
                       for n in names}, sort_keys=True, separators=(",", ":"),
                      default=str)


def proc_twin(here, data_dir, migration, out_path) -> None:
    """The fleet's CPU twin, in a process of its own (it runs while the
    fleet does): the same sequence in-process on the CPU over a copy of
    the seeded directory — each shard's ``DurableStore`` (no lease),
    ``run_recovery_pass`` at the anchor, ``run_tick`` with the worker's
    service options at each round's ``now``, the handoff through
    ``apply_release`` / ``apply_prime`` and the done-mark, and shard
    ``PROC_KILLED`` reopened after ``PROC_KILL_AFTER`` and recovered
    again, as its restarted worker is, and the agent pass (``agent_pass``, what each worker's
    ``agent_sim`` does) after ``PROC_AGENT_AFTER``. A worker's tick under
    the leader's stamp packs fresh, so the twin's ticks do too
    (``use_resident=False``: the same documents, and the same spans).
    Writes the recovery reports, the agents' counts and each shard's
    canonical documents to ``out_path``."""
    sys.path.insert(0, here)
    from evergreen_tpu_torch.parallel.topology import ShardTopology
    from evergreen_tpu_torch.scheduler import sharded_plane as sp
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.recovery import run_recovery_pass
    from evergreen_tpu_torch.storage.durable import DurableStore

    opts = wrapper.TickOptions(create_intent_hosts=True, use_cache=True,
                               solve_deadline_s=10.0, tick_budget_s=12.0,
                               async_persist=True, use_resident=False)
    t0 = time.perf_counter()
    stores = [DurableStore(data_dir, shard_id=k) for k in range(PROC_SHARDS)]
    reports = {"boot": [run_recovery_pass(s, now=PROC_ANCHOR).to_doc() for s in stores]}
    distro, src, dst, mig_now = migration
    for r in range(len(PROC_ROUNDS)):
        if r == PROC_MIGRATE:
            topo = ShardTopology(PROC_SHARDS)
            topo.affinity = ShardTopology.affinity_from_store(stores[src])
            rep = topo.placement_key(distro)
            group = sorted(d["_id"] for d in stores[src].collection("distros").find()
                           if topo.placement_key(d["_id"]) == rep)
            rec = sp.handoff_record(distro, group, src, dst, 1, mig_now,
                                    sp.handoff_payload(stores[src], group))
            sp.apply_release(stores[src], rec)
            sp.apply_prime(stores[dst], json.loads(json.dumps(rec)))
            stores[src].collection(sp.HANDOFFS_COLLECTION).update(rec["_id"],
                                                                    {"state": "done"})
        for s in stores:
            res = wrapper.run_tick(s, opts, now=proc_round_now(r), device="cpu")
            if res.degraded:
                raise RuntimeError(f"twin round {r + 1}: degraded {res.degraded!r}")
        for s in stores:
            s.sync_persist()
        if r == PROC_AGENT_AFTER:
            agents = {}
            for k, s in enumerate(stores):
                _, pairs, _, _ = agent_pass(s, proc_agent_now())
                agents[k] = dict(
                    dispatched=sum(1 for _, t in pairs if t is not None),
                    unfinished=s.collection("tasks").count(
                        lambda d: d["status"] not in ("success", "failed")))
                s.sync_persist()
        if r == PROC_KILL_AFTER:
            stores[PROC_KILLED]._journal.close()  # a SIGKILL closes nothing else
            stores[PROC_KILLED] = s2 = DurableStore(data_dir, shard_id=PROC_KILLED)
            reports["restart"] = run_recovery_pass(
                s2, now=PROC_ANCHOR + (r + 1) * TICK_STEP_S).to_doc()
    docs = [proc_docs(s) for s in stores]
    for s in stores:
        s.close()
    with open(out_path, "w") as fh:
        json.dump({"reports": reports, "docs": docs, "agents": agents,
                   "ms": (time.perf_counter() - t0) * 1e3}, fh)


def status_launches(msg) -> dict:
    """A worker's ``status`` launch counters, as ``read_launches`` reads
    this process's."""
    got = msg["launches"]
    out = {"fused_distro_stats": got["fused_distro_stats"], "segment_sum": got["segment_sum"]}
    out.update({f"segment_sum[{p}]": c for p, c in got["segment_sum_by_plan"].items()})
    return out


def nonzero(launches) -> dict:
    """``launches`` without its zero counts (a plan never launched has no
    entry in a process's counters, and ``expected_launches`` of no solve
    names every plan at 0)."""
    return {k: v for k, v in launches.items() if v}


def add_launches(total, got) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def process_fleet_phase(torch, np, problem, card="cuda", root=DATA_ROOT,
                        after_prime=None) -> dict:
    """Phase 11: the process-per-shard fleet (``FleetSupervisor`` on
    ``card``, four shard worker processes on it, the supervisor the
    solver leader with ``solver="always"``), seeded at config 3 with a
    churn that recovery heals, against a CPU twin in a process of its own.
    Returns the fleet's launches (the leader's here, the workers' from
    their ``status``), as ``read_launches`` reads them. ``card="cpu"`` rehearses it on the CPU."""
    import multiprocessing
    import shutil
    import signal

    from evergreen_tpu_torch.api.rest import RestApi
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.runtime.supervisor import (
        FleetSupervisor,
        attach_fleet_supervisor,
    )
    from evergreen_tpu_torch.scheduler.sharded_plane import fleet_owner_violations
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils.retry import RetryPolicy

    on_card = torch.device(card).type == "cuda"
    iters = CapacityConfig().iterations
    data_dir = os.path.join(root, "procfleet")
    twin_dir = os.path.join(root, "procfleet-twin")
    for d in (data_dir, twin_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    seed_proc_fleet(problem, data_dir)
    seed_ms = (time.perf_counter() - t0) * 1e3
    migration = proc_migration(data_dir)
    shutil.copytree(data_dir, twin_dir)
    out_path = os.path.join(root, "procfleet-twin.json")
    twin = multiprocessing.get_context("spawn").Process(
        target=proc_twin, args=(HERE, twin_dir, migration, out_path), daemon=True)
    twin.start()
    log(f"process fleet: config 3 (seed {SEED}) seeded over {PROC_SHARDS} shard segments "
        f"at epoch 0 in {seed_ms:.1f} ms, each shard's quota and intent budget a "
        f"quarter of phase 6's; churn written without a lease, per shard: "
        f"{PROC_STALE} tasks started on hosts whose heartbeats are stale at the "
        f"recovery anchor, {PROC_GONE} dispatched on hosts that are gone, 1 on a "
        f"terminated host, {PROC_BUILDING} mock hosts building; the CPU twin started "
        f"on a copy of the directory (pid {twin.pid})")
    sup = FleetSupervisor(
        data_dir, PROC_SHARDS, ttl_s=LEASE_TTL_S, hb_interval_s=1.0, hb_deadline_s=10.0,
        recovery_anchor=PROC_ANCHOR, orphan_grace_s=10.0, supervisor_lease_ttl_s=LEASE_TTL_S,
        restart_policy=RetryPolicy(attempts=1_000_000, base_backoff_s=0.25,
                                   max_backoff_s=2.0, jitter=0.0),
        solver="always", device=card, front_store=Store())
    # the front a ``service --shards`` process serves: a RestApi over the
    # supervisor's front store, the supervisor attached, on a socket
    attach_fleet_supervisor(sup.front_store, sup)
    front = RestApi(sup.front_store).serve("127.0.0.1", 0)
    threading.Thread(target=front.serve_forever, daemon=True).start()
    front_base = f"http://127.0.0.1:{front.server_address[1]}"
    scraped = parse_exposition(http_text(front_base, "/metrics")[2])
    serves, worker_launches, leader, agents = [], {}, {}, {}
    try:
        reset_launches(fused_distro_stats, segment_sum)
        t0 = time.perf_counter()
        sup.start()
        start_ms = (time.perf_counter() - t0) * 1e3
        check(all(h.state == "ready" for h in sup.handles.values()),
              f"process fleet: workers not ready {[h.state for h in sup.handles.values()]}")
        svc = sup.solver_service
        check(svc is not None and svc.epoch == 1, "process fleet: no solver leader")
        real_serve = svc.serve_round

        def serve(shards, seq=None, budget_s=None):
            """The leader's round, timed, with the shape keys it declined
            as drift and the floor they met."""
            floor = dict(svc.common_dims) if svc.common_dims else None
            keys, real_decline = [], svc._decline

            def decline(seg, s_, cause):
                if cause == 1:
                    keys.append(seg.shape_key())
                return real_decline(seg, s_, cause)

            svc._decline = decline
            t1 = time.perf_counter()
            try:
                outcome = real_serve(shards, seq, budget_s)
            finally:
                svc._decline = real_decline
            serves.append(dict(ms=(time.perf_counter() - t1) * 1e3, outcome=outcome,
                               drift=(floor, keys) if keys else None))
            return outcome

        svc.serve_round = serve
        for k, h in sup.handles.items():
            hello = h.hellos[0]
            check(h.epochs == [1], f"process fleet: shard {k} booted at epochs {h.epochs}")
            log(f"process fleet: shard {k} hello at epoch {h.epoch}, recovery pass "
                f"{hello['recovery_ms']:.2f} ms, recovered {hello['recovered']}")
        log(f"process fleet: FleetSupervisor.start() on {card} (fleet lease, solver "
            f"lease, spawn, backend probe, replay, recovery, hello) {start_ms:.2f} ms")
        stacked_blocks = 0
        #: local solves per (shard, process life): the killed shard's second
        #: life starts after PROC_KILL_AFTER
        local_solves = {(k, 1): 0 for k in range(PROC_SHARDS)}
        local_solves[(PROC_KILLED, 2)] = 0
        takeover_ms = None
        for r, label in enumerate(PROC_ROUNDS):
            if r == PROC_MIGRATE:
                distro, src, dst, now = migration
                t1 = time.perf_counter()
                rec = sup.migrate(distro, src, dst, now=now)
                check(rec is not None and rec["seq"] == 1 and rec["state"] == "released",
                      f"process fleet: migrate({distro}) gave {rec}")
                log(f"process fleet: migrate({distro!r}, {src}, {dst}) over the control "
                    f"protocol in {(time.perf_counter() - t1) * 1e3:.2f} ms: group "
                    f"{rec['group']}")
            n_serves = len(serves)
            t1 = time.perf_counter()
            res = sup.round(now=proc_round_now(r))
            wall = (time.perf_counter() - t1) * 1e3
            check(sorted(res) == list(range(PROC_SHARDS)),
                  f"process fleet round {label}: replies from {sorted(res)}")
            for k, rep in res.items():
                check(rep["degraded"] == "", f"round {label}: shard {k} degraded "
                      f"{rep['degraded']!r}")
                check(rep["solve"] in ("stacked", "local"), f"round {label}: shard {k} "
                      f"solve {rep['solve']!r}")
            solves = [res[k]["solve"] for k in range(PROC_SHARDS)]
            mode = "stacked" if set(solves) == {"stacked"} else "local"
            served = serves[n_serves:]
            drift = [x["drift"] for x in served if x["drift"]]
            check_plane_a_mode(r, label, mode, drift, modes=PROC_MODES)
            stacked_blocks += solves.count("stacked")
            for k in range(PROC_SHARDS):
                life = 2 if k == PROC_KILLED and r > PROC_KILL_AFTER else 1
                local_solves[(k, life)] += solves[k] == "local"
            if r == 0 and after_prime is not None:
                after_prime()
            log(f"process fleet round {label}: mode {mode} (shards {solves}, causes "
                f"{[res[k]['solve_cause'] for k in range(PROC_SHARDS)]}; leader "
                + ", ".join(f"{x['outcome']} in {x['ms']:.2f} ms" for x in served)
                + f", drift {drift}); wall {wall:.2f} ms, shard ticks ms "
                + ", ".join(f"{res[k]['ms']:.2f}" for k in range(PROC_SHARDS))
                + f"; epochs {[res[k]['epoch'] for k in range(PROC_SHARDS)]}")
            scraped = fleet_reads(front_base, sup, served, scraped, label)
            if r == PROC_KILL_AFTER:
                # every worker's counters before one of them is killed
                for k, st in sup.statuses().items():
                    worker_launches[(k, 1)] = status_launches(st)
                h = sup.handles[PROC_KILLED]
                req = h.next_req()
                h.send(op="drain", req=req)
                check(h.wait_reply("drained", 60.0, req=req) is not None,
                      f"process fleet: shard {PROC_KILLED} did not drain")
                t1 = time.perf_counter()
                os.kill(h.pid, signal.SIGKILL)
                deadline = time.time() + 120.0
                while time.time() < deadline and not (h.restarts == 1 and h.state == "ready"):
                    time.sleep(0.02)
                takeover_ms = (time.perf_counter() - t1) * 1e3
                check(h.state == "ready" and h.epochs == [1, 2] and h.exits == [-9],
                      f"process fleet: shard {PROC_KILLED} restart: state {h.state}, "
                      f"epochs {h.epochs}, exits {h.exits}")
                hello = h.hellos[-1]
                log(f"process fleet: shard {PROC_KILLED} drained, SIGKILLed and restarted "
                    f"by the watchdog at epoch {h.epoch} in {takeover_ms:.2f} ms (SIGKILL "
                    f"to the next hello: backoff {h.backoffs[-1]:.2f} s, lease TTL "
                    f"{LEASE_TTL_S} s, spawn, probe, replay, recovery); its recovery "
                    f"pass {hello['recovery_ms']:.2f} ms, recovered {hello['recovered']}")
            if r == PROC_AGENT_AFTER:
                t1 = time.perf_counter()
                agents = sup.agent_sim(now=proc_agent_now())
                check(sorted(agents) == list(range(PROC_SHARDS)),
                      f"process fleet: agent_done from {sorted(agents)}")
                log(f"process fleet: agent_sim (every worker finishes its tasks in "
                    f"flight, then dispatches every free host) in "
                    f"{(time.perf_counter() - t1) * 1e3:.2f} ms: " + json.dumps(
                        {k: [a["dispatched"], a["unfinished"]]
                         for k, a in sorted(agents.items())})
                    + " (shard: dispatched, unfinished)")
        for k, st in sup.statuses().items():
            worker_launches[(k, 2 if k == PROC_KILLED else 1)] = status_launches(st)
        leader = read_launches(fused_distro_stats, segment_sum)
        rounds = [d for d in sup.front_store.collection("spans").find()
                  if d["name"] == "fleet.round"]
        check(len(rounds) == len(PROC_ROUNDS) and all(
            d["attributes"] == {"n_shards": PROC_SHARDS} and d["parent"] is None
            for d in rounds), f"process fleet: the front store holds {len(rounds)} "
            f"fleet.round spans")
        log(f"process fleet: the front store holds one fleet.round span a round "
            f"({len(rounds)}), ms " + ", ".join(f"{d['duration_ms']:.2f}" for d in rounds))
        t1 = time.perf_counter()
        sup.stop(graceful=True)
        stop_ms = (time.perf_counter() - t1) * 1e3
    finally:
        front.shutdown()
        front.server_close()
        sup.stop(graceful=False)
    check(all(h.proc.returncode == 0 for h in sup.handles.values()),
          f"process fleet: exits {[h.proc.returncode for h in sup.handles.values()]}")
    left = [f for f in os.listdir(data_dir) if f.endswith(".lease")]
    check(left == [], f"process fleet: lease files left after stop(): {left}")
    log(f"process fleet: stop(graceful=True) in {stop_ms:.2f} ms (drain, checkpoint, "
        f"release); every worker exited 0, every lease released")

    # launches: the leader's stacked blocks here, each worker's local solves
    # in its own process (the killed one's counted before the kill)
    want = expected_launches([iters] * stacked_blocks) if on_card else {}
    check(nonzero(leader) == nonzero(want),
          f"process fleet: the leader launched {leader}, expected {want} "
          f"({stacked_blocks} stacked blocks)")
    fleet = dict(leader)
    for key, got in sorted(worker_launches.items()):
        want = expected_launches([iters] * local_solves[key]) if on_card else {}
        check(nonzero(got) == nonzero(want),
              f"process fleet: worker {key[0]} (life {key[1]}) launched "
              f"{got}, expected {want} ({local_solves[key]} local solves)")
        add_launches(fleet, got)
    log(f"process fleet launches: leader {leader} for {stacked_blocks} stacked blocks; "
        f"workers (shard.life: fused_distro_stats, segment_sum for local solves) "
        + json.dumps({f"{k}.{life}": [got["fused_distro_stats"], got["segment_sum"],
                                      local_solves[(k, life)]]
                      for (k, life), got in sorted(worker_launches.items())})
        + " (exact)")

    # the twin's documents and reports against the fleet's segments
    twin.join(timeout=600)
    check(twin.exitcode == 0, f"process fleet: the CPU twin exited {twin.exitcode}")
    with open(out_path) as fh:
        twin_out = json.load(fh)
    for k, h in sup.handles.items():
        for hello, report in zip(h.hellos, [twin_out["reports"]["boot"][k]]
                                 + ([twin_out["reports"]["restart"]]
                                    if k == PROC_KILLED else [])):
            counts = {"released_claims": len(report["released_claims"]),
                      "stranded_reset": len(report["stranded_reset"]),
                      "stale_frames_dropped": report["stale_frames_dropped"]}
            check(hello["recovered"] == counts, f"process fleet: shard {k} recovered "
                  f"{hello['recovered']}, the twin {counts}")
    got_agents = {k: {f: agents[k][f] for f in ("dispatched", "unfinished")}
                  for k in range(PROC_SHARDS)}
    check(got_agents == {int(k): v for k, v in twin_out["agents"].items()},
          f"process fleet: agent_sim counts {got_agents}, the twin's {twin_out['agents']}")
    check(sum(a["dispatched"] for a in got_agents.values()) > 0,
          "process fleet: agent_sim dispatched nothing")
    boot = twin_out["reports"]["boot"]
    check(all(b["released_claims"] and b["stranded_reset"] and b["hosts_terminated"]
              for b in boot), "process fleet: a shard's recovery did not act on each step")
    t0 = time.perf_counter()
    stores = [DurableStore(data_dir, shard_id=k) for k in range(PROC_SHARDS)]
    for s in stores:
        s._journal.close()  # inspection-open: never close() (a checkpoint)
    read_ms = (time.perf_counter() - t0) * 1e3
    check(fleet_owner_violations(stores) == [],
          "process fleet: a document has two owners")
    n_docs = 0
    for k, s in enumerate(stores):
        got = proc_docs(s)
        check(got == twin_out["docs"][k], f"process fleet: shard {k}'s documents differ "
              f"from the CPU twin's")
        n_docs += sum(len(s.collection(n)) for n in s._collections)
    log(f"process fleet: after stop, the four segments (replayed read-only in "
        f"{read_ms:.2f} ms) hold {n_docs} documents, each shard's equal to the CPU "
        f"twin's (twin {twin_out['ms']:.0f} ms in its own process; intent and event ids, "
        f"intents' secrets and creation times canonicalised); one owner per document; "
        f"recovery counts equal the twin's: boot " + json.dumps(
            [{k: len(v) for k, v in b.items() if isinstance(v, list)} for b in boot])
        + ", restart " + json.dumps({k: len(v) for k, v in
                                     twin_out["reports"]["restart"].items()
                                     if isinstance(v, list)}))
    shutil.rmtree(root, ignore_errors=True)
    return fleet



# ---- phase 10's durable fleet and phase 11, in a process of their own ------- #

#: the fleet process's data directories (inside the checkout, gitignored,
#: removed at the end), and how long the main process waits for it once
#: phase 10's durable tick is done
FLEET_ROOT = os.path.join(HERE, "_smoke_fleet")
FLEET_WAIT_S = 600.0


def fleet_phases(torch, np, problem, card="cuda", root=FLEET_ROOT, after_prime=None) -> dict:
    """Phase 10's durable fleet (``fleet_phase``), then phase 11
    (``process_fleet_phase``), each one's wall on its own line. They share
    no store, directory or port with phases 9 and 10's durable tick, so
    ``main`` runs them in a process of their own beside those
    (``start_fleet_child``). Returns their card launches:
    ``{"durable fleet": ..., "fleet": ...}``. ``card="cpu"`` rehearses both
    on the CPU (pass a root outside the checkout)."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    keep = {d.id for d in problem[0][:-1]}
    launches_by = {"fleet": {}}
    t0 = time.perf_counter()
    fleet_phase(torch, np, problem, keep, card, os.path.join(root, "durable-fleet"),
                launches_by)
    t1 = time.perf_counter()
    log(f"phase 10 (the durable fleet): {t1 - t0:.1f} s wall")
    log(f"process fleet on {card}")
    proc = process_fleet_phase(torch, np, problem, card=card, root=root,
                               after_prime=after_prime)
    log(f"phase 11: {time.perf_counter() - t1:.1f} s wall")
    shutil.rmtree(root, ignore_errors=True)
    return {"durable fleet": launches_by["fleet"], "fleet": proc,
            "walls": {"phase 10 (the durable fleet)": t1 - t0,
                      "phase 11": time.perf_counter() - t1}}


def fleet_child(here, out_path, t0_wall, gate, card="cuda", primed=None) -> None:
    """The ``spawn`` process of ``start_fleet_child``: its imports and
    config 3, then, once ``gate`` is set, ``fleet_phases`` on ``card`` (it
    touches the card only after the gate: phases 8 and 9's readings of
    the device are taken with no other process on the card), its lines on the shared output
    tagged and on the script's clock (``t0_wall``: the wall time of the
    script's start); writes ``{"ok": ..., the launches or "error"}`` to
    ``out_path``."""
    global _T0, _TAG
    _T0 = time.perf_counter() - (time.time() - t0_wall)
    _TAG = "[fleet process] "
    sys.path.insert(0, here)
    result = {"ok": False}
    try:
        import numpy as np
        import torch

        from evergreen_tpu_torch.ops import _build
        from evergreen_tpu_torch.utils.benchgen import generate_problem

        problem = generate_problem(*CONFIG3, seed=SEED)
        t0 = time.perf_counter()
        gate.wait()
        log(f"imported and generated config 3, then waited {time.perf_counter() - t0:.1f} "
            f"s for phase 9's profiled round")
        if card == "cuda":
            torch.cuda.set_device(0)
            _build.build(("distro_stats", "segment_sum"))  # phase 1 built them: loads
        result.update(fleet_phases(torch, np, problem, card=card,
                                   after_prime=None if primed is None else primed.set),
                      ok=True)
    except BaseException:
        import traceback

        result["error"] = traceback.format_exc()
        raise
    finally:
        if primed is not None:
            primed.set()
        with open(out_path, "w") as fh:
            json.dump(result, fh)


def start_fleet_child(card="cuda", primed=None) -> dict:
    """``fleet_child`` started in a ``spawn`` process (not daemonic: phase
    11 starts its CPU twin in a process of its own), with the event it
    waits for before it touches the card (``"gate"``: ``main`` sets it when
    phase 8, which times a kernel, and phase 9's profiled round are done);
    it sets ``primed``, where given, once phase 11's prime round is done
    (or once it ends); ``card="cpu"`` rehearses it on the CPU."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    out_path = os.path.join(tempfile.mkdtemp(prefix="evg-chip-fleet-"), "result.json")
    t0_wall = time.time() - (time.perf_counter() - _T0)
    gate = ctx.Event()
    proc = ctx.Process(target=fleet_child,
                       args=(HERE, out_path, t0_wall, gate, card, primed))
    proc.start()
    return {"proc": proc, "gate": gate, "out": out_path, "t0": time.perf_counter()}


def stop_fleet_child(child) -> None:
    """End the fleet process if it still runs (a failure elsewhere)."""
    proc = child["proc"]
    if proc.is_alive():
        proc.terminate()
        proc.join(30)
    if proc.is_alive():
        proc.kill()
        proc.join(30)


def join_fleet_child(child) -> dict:
    """Wait for the fleet process; its result, or the failure it wrote."""
    import shutil

    proc = child["proc"]
    t0 = time.perf_counter()
    proc.join(FLEET_WAIT_S)
    waited = time.perf_counter() - t0
    if proc.is_alive():
        stop_fleet_child(child)
    result = {}
    if os.path.exists(child["out"]):
        with open(child["out"]) as fh:
            result = json.load(fh)
    shutil.rmtree(os.path.dirname(child["out"]), ignore_errors=True)
    check(proc.exitcode == 0 and result.get("ok"),
          f"the fleet process (phase 10's durable fleet, phase 11) ended with exit code "
          f"{proc.exitcode}: {result.get('error', '')[-3000:]}")
    log(f"the fleet process (phase 10's durable fleet, phase 11) ended "
        f"{time.perf_counter() - child['t0']:.1f} s after its start, beside phases 9, 6, 7 "
        f"and 10; waited {waited:.1f} s for it here")
    return result


#: the scenario process (``start_scenario_child``): the port's scenario
#: engine on the card beside phases 9 (after its profiled round), 6, 7,
#: 10, 12 and 13, its data directories and its trace under this root, in
#: the system's temp dir as the engine's own default (on the card's
#: machine a healthy commit of the timed case took 2.3 ms at the median
#: under the checkout against 1.7 there: ``--timed``), one root for each
#: checkout
SCENARIO_ROOT = os.path.join(
    __import__("tempfile").gettempdir(),
    "evg-smoke-scenarios-" + __import__("hashlib").sha1(HERE.encode()).hexdigest()[:12])
SCENARIO_WAIT_S = 600.0
#: the fuzz campaign's seeds, from FUZZCARD_GREEN.json's start seed (16
#: until step 5 came beside phases 10-13 and the phases ended past 400 s;
#: the CPU tests hold 48 seeds' weathers and 16 cases to JAX's)
FUZZ_SEEDS = 8
#: the second card run of the specs SCORECARD_GREEN.json pins (the
#: others always run twice: their determinism has no other witness; cut
#: when the crash round came)
PINNED_TWICE = False
#: ``config3-failover``'s ticks (5 until the crash round came)
FAILOVER_TICKS = 4
#: the matrix case whose ladder rides the real commit latency: held by
#: its verdicts, not its fingerprint, and run by the scenario process
#: last, once ``main`` has ended phase 13 and waits (``timed_round``):
#: beside phase 9 and the fleet process its recovery to GREEN failed, the
#: WAL's commit latency held above the 3 ms YELLOW rung by the host's
#: load, and so did its CPU twin in the main process after phase 13
TIMED_CASES = ("overload-slow-store-storm",)


def scenario_specs() -> list:
    """(name, spec factory) of the 13 library weathers, the checked-in
    regression specs and the 9 matrix cases."""
    from evergreen_tpu_torch.scenarios import (
        FAULT_SCENARIO_CASES,
        OVERLOAD_SCENARIO_CASES,
        SCENARIOS,
    )
    from evergreen_tpu_torch.scenarios.trace import load_regression_specs

    out = list(SCENARIOS.items()) + sorted(load_regression_specs().items())
    for prefix, reg in (("fault", FAULT_SCENARIO_CASES),
                        ("overload", OVERLOAD_SCENARIO_CASES)):
        out += [(f"{prefix}-{n}", (lambda f=f: f(0))) for n, f in reg.items()]
    return out


def config3_failover_spec(hosts_per_distro=20):
    """The weather of a durable single-store deployment at config 3 that
    loses its writer region mid-commit, from the engine's vocabulary:
    tick 0 seeds config 3 (``_seed_problem_event``); tick 1's group commit
    tears (the seam's next call); tick 3 arms the lease steal at the next
    commit's fence; one fenced tick and one failover, the default
    invariants. The tick pipeline alone, as the matrix cases run it: with
    the service loop (and the seeded hosts put in the mock cloud, or its
    monitor terminates them) its CPU twin took 109.9 s, more than its
    place beside phases 10-13 allows."""
    from evergreen_tpu_torch.scenarios import SLO, Ev, ScenarioSpec
    from evergreen_tpu_torch.scenarios.matrix import _seed_problem_event

    return ScenarioSpec(
        name="config3-failover",
        description="config 3 on a durable store: a torn WAL frame, then the "
                    "writer's lease stolen mid-commit and a failover",
        ticks=FAILOVER_TICKS,
        durable=True,
        service_loop=False,
        events=[
            _seed_problem_event(*CONFIG3, seed=SEED, hosts_per_distro=hosts_per_distro),
            Ev(1, "fault", {"seam": "wal.commit", "kind": "torn"}),
            Ev(3, "lease_steal", {}),
        ],
        slos=[SLO("one-fenced-tick", "fenced_ticks", "==", 1),
              SLO("one-failover", "failovers", "==", 1)],
    )


class SolveLog:
    """Counts the tick's device solves: wraps the solve ``run_tick``
    calls (``scheduler/wrapper.py``'s ``run_solve_packed``) and notes the
    capacity trip count of each snapshot it is handed, so that the
    kernels' counts can be held to ``expected_launches`` of those
    solves."""

    def __init__(self):
        from evergreen_tpu_torch.ops.solve import capacity_iters
        from evergreen_tpu_torch.scheduler import wrapper

        self.iters = []
        self._lock = threading.Lock()
        real = wrapper.run_solve_packed

        def counted(snapshot, *a, **kw):
            with self._lock:
                self.iters.append(capacity_iters(snapshot))
            return real(snapshot, *a, **kw)

        wrapper.run_solve_packed = counted


def join_abandoned_solves() -> None:
    """A solve abandoned at its tick's deadline still runs to its end on
    its own thread (``_solve_bounded``): wait for it."""
    for th in threading.enumerate():
        if th.name == "tick-solve":
            th.join(30)


def device_ticks(run) -> int:
    """The ticks whose solve ran on the run's device: planned by it, or
    abandoned at the deadline (which solves on)."""
    return sum(r.planner_used == "tpu" or r.degraded == "solve-deadline"
               for r in run.tick_results)


def scenario_run(spec, card, solves, totals, keep_data_dir=False):
    """One ``ScenarioRun`` of ``spec`` on ``card`` with the mock cloud
    reset; on the card, its launches held exact against the solves of
    its ticks and added to ``totals``. Returns (entry, run)."""
    from evergreen_tpu_torch.cloud.mock import MockCloudManager
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scenarios import ScenarioRun

    MockCloudManager.reset()
    reset_launches(fused_distro_stats, segment_sum)
    del solves.iters[:]
    run = ScenarioRun(spec, device=card, keep_data_dir=keep_data_dir)
    entry = run.execute()
    join_abandoned_solves()
    got = read_launches(fused_distro_stats, segment_sum)
    n = device_ticks(run)
    check(len(solves.iters) == n, f"{spec.name} on {card}: {len(solves.iters)} solves "
          f"for {n} device ticks")
    if card == "cuda":
        want = expected_launches(solves.iters) if n else {}
        check({k: v for k, v in got.items() if v} == {k: v for k, v in want.items() if v},
              f"{spec.name}: launches {got}, expected {want} for {n} solves")
        add_launches(totals, got)
    return entry, run


def failed(entry) -> dict:
    if entry is None:
        return {}
    return {f"{sec}.{k}": v["detail"] for sec in ("invariants", "checks", "slos")
            for k, v in entry.get(sec, {}).items() if not v["ok"]}


def weather_round(card, solves, totals, green) -> None:
    """Step 1: every spec of ``scenario_specs`` but ``TIMED_CASES`` twice
    on the card (once for the pinned ones without ``PINNED_TWICE``) and
    once on the CPU."""
    pinned = 0
    for name, factory in scenario_specs():
        if name in TIMED_CASES:
            continue
        t0 = time.perf_counter()
        a, run = scenario_run(factory(), card, solves, totals)
        t1 = time.perf_counter()
        spec_name = a["name"]
        b = None
        if spec_name not in green or PINNED_TWICE:
            b, _ = scenario_run(factory(), card, solves, totals)
        t2 = time.perf_counter()
        c, _ = scenario_run(factory(), "cpu", solves, totals)
        t3 = time.perf_counter()
        for label, e in (("card", a), ("second card run", b), ("CPU", c)):
            check(e is None or e["ok"], f"{spec_name} ({label}): {failed(e)}")
        check(b is None or a["fingerprint"] == b["fingerprint"],
              f"{spec_name}: two card runs, fingerprints {a['fingerprint']} "
              f"{b and b['fingerprint']}")
        check(a["fingerprint"] == c["fingerprint"],
              f"{spec_name}: card {a['fingerprint']}, CPU {c['fingerprint']}: "
              + json.dumps({k: (a[k], c[k]) for k in a
                            if k not in ("timing", "fingerprint") and a[k] != c[k]})[:2000])
        if spec_name in green:
            pinned += 1
            check(a["fingerprint"] == green[spec_name]["fingerprint"],
                  f"{spec_name}: fingerprint {a['fingerprint']}, SCORECARD_GREEN.json "
                  f"{green[spec_name]['fingerprint']}")
        log(f"scenario {spec_name}: ok; card {t1 - t0:.2f} s ({len(run.tick_results)} "
            f"ticks, {device_ticks(run)} solved on the card), CPU {t3 - t2:.2f} s; "
            f"fingerprint {a['fingerprint']}"
            + (" = SCORECARD_GREEN.json" if spec_name in green else ""))
    check(pinned == 20, f"{pinned} specs held to SCORECARD_GREEN.json, expected 20")


def timed_round(card, solves, totals) -> float:
    """``TIMED_CASES`` twice on the card and once on the CPU: each ok, the
    card's checks, invariants and SLOs equal to the CPU's. Returns its
    wall."""
    t0 = time.perf_counter()
    for name, factory in scenario_specs():
        if name not in TIMED_CASES:
            continue
        runs = [scenario_run(factory(), dev, solves, totals)[0]
                for dev in (card, card, "cpu")]
        for e, label in zip(runs, ("card", "second card run", "CPU")):
            check(e["ok"], f"{name} ({label}): {failed(e)}; dwell {e['dwell_ticks']}")
        for e in runs[:2]:
            for f in ("checks", "invariants", "slos"):
                check(e[f] == runs[2][f], f"{name}: {f} differ from the CPU's")
        log(f"scenario {name} (timed: the WAL's real commit latency drives its ladder), "
            f"once phase 13 had ended: ok twice on the card and on the CPU, verdicts "
            f"equal, in {time.perf_counter() - t0:.2f} s; dwell ticks "
            + ", ".join(json.dumps(e["dwell_ticks"]) for e in runs))
    return time.perf_counter() - t0


def mount_of(path) -> str:
    """The filesystem type and mount point that hold ``path``, from
    ``/proc/mounts`` (the longest mount point that prefixes it)."""
    real, best = os.path.realpath(path), ("?", "")
    with open("/proc/mounts") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3:
                continue
            point = parts[1].replace("\\040", " ")
            if ((real == point or real.startswith(point.rstrip("/") + "/"))
                    and len(point) >= len(best[1])):
                best = (parts[2], point)
    return f"{best[0]} at {best[1]}"


class CommitSplit:
    """``--timed``'s split of each WAL group commit the ladder samples
    (``store_latency_ms``), by wrappers on the durable store's commit
    path (this tree's, or an older one's, whose flusher re-reads the
    lease file for every frame): the commit boundary (``wal.fence``, the
    detach and the lease-file check: ``_queue_group``, or
    ``end_tick_async``), the wait until the flusher starts the write,
    the write (``commit_group_inline``), of it the journal's write and
    flush, the wait until ``_drain_flusher`` returns, and what the sample holds
    beyond ``end_tick`` (the ``wal_commit`` span); with the lease and
    floor files' reads (and of them the files' open, read and close,
    ``_read_bytes``, where the tree has it), the Python threads alive at
    the commit and the collector's ms inside it."""

    def __init__(self):
        import gc

        from evergreen_tpu_torch.storage import durable
        from evergreen_tpu_torch.storage.lease import FileLease
        from evergreen_tpu_torch.utils import overload

        self.ticks, self.cur, self._gc0 = [], None, None
        self.restore = []
        cls = durable.DurableStore

        def wrap(owner, name, after):
            real = getattr(owner, name)

            def wrapped(*a, **kw):
                rec = self.cur
                t0 = time.perf_counter()
                try:
                    return real(*a, **kw)
                finally:
                    if rec is not None:
                        after(rec, t0, time.perf_counter())

            setattr(owner, name, wrapped)
            self.restore.append((owner, name, real))

        real_end_tick = cls.end_tick

        def end_tick(store):
            rec = {"t0": time.perf_counter(), "lease_ms": 0.0, "gc_ms": 0.0,
                   "data_dir": store.data_dir,
                   "threads": sorted(t.name for t in threading.enumerate())}
            self.cur = rec
            try:
                return real_end_tick(store)
            finally:
                rec["t_end"] = time.perf_counter()
                self.cur = None
                self.ticks.append(rec)

        cls.end_tick = end_tick
        self.restore.append((cls, "end_tick", real_end_tick))

        def stamp(key):
            def after(rec, t0, t1):
                rec[key] = (t0, t1)
            return after

        def lease_after(rec, t0, t1):
            rec["lease_ms"] += (t1 - t0) * 1e3

        wrap(cls, "_queue_group" if hasattr(cls, "_queue_group") else "end_tick_async",
             stamp("boundary"))
        wrap(cls, "commit_group_inline", stamp("writer"))
        wrap(cls, "_drain_flusher", stamp("drain"))
        wrap(durable._Journal, "commit_group", stamp("write"))
        wrap(FileLease, "peek", lease_after)
        wrap(FileLease, "_epoch_floor", lease_after)

        def file_after(rec, t0, t1):
            rec["file_ms"] = rec.get("file_ms", 0.0) + (t1 - t0) * 1e3

        from evergreen_tpu_torch.storage import lease as lease_mod

        if hasattr(lease_mod, "_read_bytes"):
            wrap(lease_mod, "_read_bytes", file_after)
        real_observe = overload.LoadMonitor.observe

        def observe(monitor, name, value, ewma=0.0):
            if name == "store_latency_ms" and self.ticks and "sample_ms" not in self.ticks[-1]:
                self.ticks[-1]["sample_ms"] = value
            return real_observe(monitor, name, value, ewma)

        overload.LoadMonitor.observe = observe
        self.restore.append((overload.LoadMonitor, "observe", real_observe))

        def on_gc(phase, info):
            rec = self.cur
            if rec is None:
                return
            if phase == "start":
                self._gc0 = time.perf_counter()
            elif self._gc0 is not None:
                rec["gc_ms"] += (time.perf_counter() - self._gc0) * 1e3
                self._gc0 = None

        gc.callbacks.append(on_gc)
        self._on_gc = on_gc

    def close(self) -> None:
        import gc

        gc.callbacks.remove(self._on_gc)
        for owner, name, real in reversed(self.restore):
            setattr(owner, name, real)

    def take(self) -> list:
        """The split of each commit the ladder sampled since the last
        ``take`` (ms), in tick order."""
        out = []
        for rec in self.ticks:
            if "sample_ms" not in rec or "boundary" not in rec:
                continue
            a0, a1 = rec["boundary"]
            c0, c1 = rec.get("writer", (a1, a1))
            w0, w1 = rec.get("write", (c0, c0))
            d0, d1 = rec.get("drain", (c1, c1))
            out.append({
                "sample": rec["sample_ms"],
                "boundary": (a1 - a0) * 1e3,
                "to_writer": (c0 - a1) * 1e3,
                "writer": (c1 - c0) * 1e3,
                "write_flush": (w1 - w0) * 1e3,
                "to_drained": (d1 - c1) * 1e3,
                "lease_read": rec["lease_ms"],
                "file_read": rec.get("file_ms", 0.0),
                "beyond_end_tick": rec["sample_ms"] - (rec["t_end"] - rec["t0"]) * 1e3,
                "gc": rec["gc_ms"],
                "threads": rec["threads"],
                "data_dir": rec["data_dir"],
            })
        del self.ticks[:]
        return out


TIMED_PARTS = ("sample", "boundary", "to_writer", "writer", "write_flush", "to_drained",
               "lease_read", "file_read", "beyond_end_tick", "gc")
#: the healthy ticks of the timed case (its fault covers ticks 0-3) and
#: the bound ``--timed`` reads their commit's p99 against: half the 3 ms rung
TIMED_HEALTHY_FROM = 4
TIMED_P99_MS = 1.5


def pct(xs, q) -> float:
    """The ``q`` quantile of ``xs`` (nearest rank)."""
    import math

    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


FS_PROBE_READS = 400


def fs_probe(root) -> None:
    """The cost of one fence check's file reads where the timed case
    keeps its data: a lease taken in a fresh directory under ``root``,
    then ``FS_PROBE_READS`` reads each of its lease file and its floor
    file as the store reads them (``_read_bytes``: by path), of the lease
    file relative to an open descriptor of its directory, and a
    ``stat`` of it; p50, p99 and max ms of each."""
    import shutil
    import tempfile

    from evergreen_tpu_torch.storage import lease as lease_mod

    d = tempfile.mkdtemp(prefix="fs-probe-", dir=root)
    try:
        lease = lease_mod.FileLease(os.path.join(d, "writer.lease"))
        check(lease.try_acquire(), "fs probe: no lease")
        dfd = os.open(d, os.O_RDONLY)

        def relative():
            fd = os.open("writer.lease", os.O_RDONLY, dir_fd=dfd)
            try:
                return os.read(fd, 65536)
            finally:
                os.close(fd)

        ways = {"lease by path": lambda: lease_mod._read_bytes(lease.path),
                "floor by path": lambda: lease_mod._read_bytes(lease._floor_path()),
                "lease by dir fd": relative,
                "stat of the lease": lambda: os.stat(lease.path)}
        got = {}
        for name, fn in ways.items():
            ms = []
            for _ in range(FS_PROBE_READS):
                t0 = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t0) * 1e3)
            got[name] = ms
        os.close(dfd)
        lease.release()
        log(f"fs probe under {root} ({mount_of(d)}), {FS_PROBE_READS} each, ms p50/p99/max: "
            + "; ".join(f"{k} {pct(v, .5):.3f}/{pct(v, .99):.3f}/{max(v):.3f}"
                        for k, v in got.items()))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def timed_rounds(n, root=None, card="cuda") -> None:
    """``chip_smoke.py --timed N [ROOT]``: ``timed_round`` N times (each
    twice on the card and once on the CPU, all three ok, no retry), its
    data directories under ``ROOT`` (default: the system's temp dir, as
    the engine's own default); for every tick, the commit's split
    (``CommitSplit``); per run the healthy ticks' quantiles; at the end
    the healthy commits' p99 over every run against ``TIMED_P99_MS``,
    printed as met or not (on a remote filesystem the fence check's two
    file reads can exceed it)."""
    import shutil
    import tempfile

    root = root or tempfile.mkdtemp(prefix="evg-chip-timed-")
    os.makedirs(root, exist_ok=True)
    tempfile.tempdir = root
    solves, totals, split = SolveLog(), {}, CommitSplit()
    healthy = {"card": [], "cpu": []}
    passed = 0
    try:
        log(f"--timed: data under {root} ({mount_of(root)}); switch interval "
            f"{sys.getswitchinterval() * 1e3:.1f} ms; Python threads "
            + json.dumps(sorted(t.name for t in threading.enumerate())))
        fs_probe(root)
        for i in range(n):
            runs = []
            for dev in (card, card, "cpu"):
                entry, _ = scenario_run(dict(scenario_specs())[TIMED_CASES[0]](), dev,
                                        solves, totals)
                ticks = split.take()
                runs.append((dev, entry, ticks))
            for j, (dev, entry, ticks) in enumerate(runs):
                for k, t in enumerate(ticks):
                    log(f"timed {i}.{j} {dev} tick {k}: " + " ".join(
                        f"{p}={t[p]:.3f}" for p in TIMED_PARTS)
                        + f" threads={','.join(t['threads'])}")
                good = ticks[TIMED_HEALTHY_FROM:]
                healthy["cpu" if j == 2 else "card"] += [t["sample"] for t in good]
                log(f"timed {i}.{j} on {dev}: ok={entry['ok']} dwell {entry['dwell_ticks']}; "
                    f"healthy ticks' ms p50/p99/max " + ", ".join(
                        f"{p} {pct([t[p] for t in good], .5):.3f}/"
                        f"{pct([t[p] for t in good], .99):.3f}/{max(t[p] for t in good):.3f}"
                        for p in TIMED_PARTS) + f"; data dir on {mount_of(ticks[0]['data_dir'])}")
            ok = all(e["ok"] for _, e, _ in runs) and all(
                e[f] == runs[2][1][f] for _, e, _ in runs[:2]
                for f in ("checks", "invariants", "slos"))
            passed += ok
            log(f"timed round {i}: {'ok' if ok else 'FAILED: ' + json.dumps([failed(e) for _, e, _ in runs])}")
    finally:
        split.close()
        tempfile.tempdir = None
        shutil.rmtree(root, ignore_errors=True)
    allh = healthy["card"] + healthy["cpu"]
    p99 = pct(allh, .99)
    log(f"--timed {n}: {passed} of {n} rounds ok; healthy ticks ({TIMED_HEALTHY_FROM}-27) "
        f"commit p50 {pct(allh, .5):.3f} ms, p99 {p99:.3f} ms, max {max(allh):.3f} ms over "
        f"{len(allh)} commits (card runs p99 {pct(healthy['card'], .99):.3f}, CPU runs p99 "
        f"{pct(healthy['cpu'], .99):.3f}); the p99 bound {TIMED_P99_MS} ms "
        f"{'met' if p99 < TIMED_P99_MS else 'NOT met'}; card launches {nonzero(totals)}")
    check(passed == n, f"--timed: {passed} of {n} rounds ok")


def fuzz_round(card, solves, totals, start_seed) -> dict:
    """Step 2: ``FUZZ_SEEDS`` generated weathers from ``start_seed``,
    twice on the card and once on the CPU; then the engine's sabotage
    self-test on the card, its launches held to its solves."""
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scenarios.fuzz import generate_weather, sabotage_selftest

    t0 = time.perf_counter()
    for seed in range(start_seed, start_seed + FUZZ_SEEDS):
        a, _ = scenario_run(generate_weather(seed), card, solves, totals)
        b, _ = scenario_run(generate_weather(seed), card, solves, totals)
        c, _ = scenario_run(generate_weather(seed), "cpu", solves, totals)
        check(a["ok"] and b["ok"] and c["ok"],
              f"fuzz seed {seed}: {failed(a)} {failed(b)} {failed(c)}")
        check(a["fingerprint"] == b["fingerprint"] == c["fingerprint"],
              f"fuzz seed {seed}: fingerprints {a['fingerprint']} {b['fingerprint']} "
              f"(CPU {c['fingerprint']})")
    t1 = time.perf_counter()
    reset_launches(fused_distro_stats, segment_sum)
    del solves.iters[:]
    res = sabotage_selftest(device=card)
    join_abandoned_solves()
    got = read_launches(fused_distro_stats, segment_sum)
    if card == "cuda":
        want = expected_launches(solves.iters)
        check(got == want, f"sabotage self-test: launches {got}, expected {want} for "
              f"{len(solves.iters)} solves")
        add_launches(totals, got)
    check(res["ok"] and res["caught"] and res["still_caught"] and res["deterministic"],
          f"sabotage self-test: {res}")
    t2 = time.perf_counter()
    log(f"fuzz: {FUZZ_SEEDS} weathers from seed {start_seed} ok, deterministic on the "
        f"card and equal to the CPU in {t1 - t0:.1f} s; the sabotage self-test caught "
        f"{res['red']}, shrank it to {res['shrunk_events']} events, deterministic, in "
        f"{t2 - t1:.1f} s ({len(solves.iters)} solves)")
    return {"fuzz": t1 - t0, "sabotage": t2 - t1}


def failover_round(card, solves, totals) -> dict:
    """Step 3: ``config3-failover`` once on the card and once on the CPU:
    both ok, ``resume_equals_rerun`` held, one fingerprint."""
    out = {}
    entries = {}
    for dev in (card, "cpu"):
        t0 = time.perf_counter()
        e, run = scenario_run(config3_failover_spec(), dev, solves, totals)
        out[dev] = time.perf_counter() - t0
        entries[dev] = e
        check(e["ok"] and "resume_equals_rerun" in e["invariants"],
              f"config3-failover on {dev}: {failed(e)}")
        log(f"config3-failover on {dev}: ok in {out[dev]:.1f} s; ticks (ms) "
            + ", ".join(f"{r.total_ms:.0f} ({r.planner_used}{' ' + r.degraded if r.degraded else ''})"
                        for r in run.tick_results)
            + f"; degraded {e['degraded']}, stats {json.dumps(e['stats'])}")
    check(entries[card]["fingerprint"] == entries["cpu"]["fingerprint"],
          f"config3-failover: card {entries[card]['fingerprint']}, CPU "
          f"{entries['cpu']['fingerprint']}")
    return out


def trace_round(card, solves, totals, root) -> tuple:
    """Step 4: ``region-failover`` under a ``TraceRecorder`` on the card
    (its data directory kept), compiled from the recorded events and
    from the data directory; each spec replayed twice on the card, ok
    and deterministic. Returns (the recorder's JSONL file, walls)."""
    import shutil

    from evergreen_tpu_torch.scenarios import SCENARIOS
    from evergreen_tpu_torch.scenarios.trace import TraceRecorder, capture_data_dir

    path = os.path.join(root, "region-failover.jsonl")
    t0 = time.perf_counter()
    with TraceRecorder(path=path) as rec:
        e, run = scenario_run(SCENARIOS["region-failover"](), card, solves, totals,
                              keep_data_dir=True)
    check(e["ok"], f"region-failover under the recorder: {failed(e)}")
    try:
        specs = {"recorded": rec.spec(name="captured-region-failover"),
                 "data dir": capture_data_dir(run.data_dir, name="captured-region-failover")}
    finally:
        shutil.rmtree(run.data_dir, ignore_errors=True)
    for how, spec in specs.items():
        a, _ = scenario_run(spec, card, solves, totals)
        b, _ = scenario_run(spec, card, solves, totals)
        check(a["ok"] and b["ok"] and a["fingerprint"] == b["fingerprint"],
              f"trace replay ({how}): {failed(a)} {failed(b)} {a['fingerprint']} "
              f"{b['fingerprint']}")
        log(f"trace capture: the spec compiled from the {how} ({spec.ticks} ticks, "
            f"{len(spec.events)} events) replays ok and deterministic on the card, "
            f"{a['fingerprint']}")
    log(f"trace capture: {len(rec.events)} events recorded to {os.path.basename(path)} "
        f"({os.path.getsize(path)} bytes); {time.perf_counter() - t0:.1f} s")
    return path, time.perf_counter() - t0


#: step 5 of the scenario process: the process backend's weathers on the
#: card (``procs_round``), each once (real processes and clocks: not
#: deterministic), each held to a CPU run of its workload's uninterrupted
#: reference fleet (``proc_cpu_references``, run before the process's
#: gate); then one crash-matrix kill point and, with ``PROC_SELFTEST``,
#: the proc sabotage self-test against its CPU twin. A worker on the card
#: boots in 14-34 s (its backend probe, torch, CUDA), so each replay
#: costs 24-68 s there, and its processes load the host beside phases
#: 10-13: a worker kill and a leader's death at the stacked solve's
#: return fit beside the crash process (``leader-death``, the leader and
#: then a worker at once, 27-50 s, was cut when it came);
#: ``proc-net-oneway-partition`` (44 s) and the self-test (79 s) run on
#: the CPU (tests/test_torch_procs*.py)
PROC_CARD_WEATHERS = ("proc-fleet-sigkill", "proc-leader-kill-return")
PROC_CRASH_POINT = ("wal.commit", 1)
PROC_SELFTEST = False
#: the network-chaos matrix's point in step 5, after the crash point: a
#: solver return delayed past the workers' solve timeout, where the
#: card's stacked solve is the subject (its workload is
#: ``proc-leader-kill-return``'s but for its deadlines, so its CPU
#: reference is that one's); the other nine fleet points run on the CPU
#: (``tests/test_torch_net_matrix_procs.py``, ``python -m
#: evergreen_tpu_torch.scenarios.net_matrix --device cpu``)
PROC_NET_POINT = "leader2:solver.return:delay"


class ProcLog:
    """What the proc replays of this process ran: every ``ProcScenarioRun``
    executed (``runs``), every supervisor start's wall (``starts``: the
    fleet lease, the workers' spawn, backend probe, replay, recovery and
    hello, in parallel; or a successor's adoption), and, for each block a
    stacked solve of the solver leader returned on the card, the stack's
    capacity trip count (``stacked``)."""

    def __init__(self):
        from evergreen_tpu_torch.parallel import sharded
        from evergreen_tpu_torch.runtime.supervisor import FleetSupervisor
        from evergreen_tpu_torch.scenarios.procs import ProcScenarioRun

        self.runs, self.starts, self.stacked = [], [], []
        self._lock = threading.Lock()
        real_solve = sharded.StackedSolveCache.solve_blocks
        real_start = FleetSupervisor.start
        real_execute = ProcScenarioRun.execute

        def solve_blocks(cache, blocks):
            out = real_solve(cache, blocks)
            if cache.device.type == "cuda":
                with self._lock:
                    self.stacked += [sharded._blocks_cap_iters(blocks)] * len(blocks)
            return out

        def start(sup, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real_start(sup, *a, **kw)
            finally:
                self.starts.append((sup.device.type, time.perf_counter() - t0))

        def execute(run):
            self.runs.append(run)
            return real_execute(run)

        sharded.StackedSolveCache.solve_blocks = solve_blocks
        FleetSupervisor.start = start
        ProcScenarioRun.execute = execute

    def clear(self) -> None:
        del self.runs[:], self.stacked[:]


def worker_lives(run) -> dict:
    """Each shard worker life of a proc replay, keyed (shard, epoch): its
    last round reply's kernel counters and card solves, and the local
    device solves its replies report (planned by the device, not
    stacked)."""
    lives = {}
    for rnd in run.rounds:
        for k, rep in rnd.items():
            if "launches" not in rep:
                continue
            life = lives.setdefault((k, rep["epoch"]), {"local": 0})
            life["launches"] = status_launches(rep)
            life["card_solves"] = rep["card_solves"]
            life["local"] += rep.get("planner") == "tpu" and rep.get("solve") != "stacked"
    return lives


def proc_card_launches(plog, card, label) -> dict:
    """The card launches of the proc replays ``plog`` saw since its last
    ``clear``: this process's (the solver leader's) held exact against
    the stacked blocks it solved, each worker life's last reported
    counters against the card solves it reported, which cover its
    rounds' local solves. Returns their sum (on the CPU, nothing)."""
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scenarios.crash_matrix import expected_launches as solve_launches

    leader = read_launches(fused_distro_stats, segment_sum)
    out = {}
    stacked = sum(r.get("solve") == "stacked"
                  for run in plog.runs for rnd in run.rounds for r in rnd.values())
    if card == "cuda":
        want = expected_launches(plog.stacked) if plog.stacked else {}
        check(nonzero(leader) == nonzero(want),
              f"{label}: the leader launched {leader}, expected {want} for "
              f"{len(plog.stacked)} stacked blocks")
        check(stacked <= len(plog.stacked),
              f"{label}: {stacked} stacked replies, {len(plog.stacked)} blocks solved")
        add_launches(out, leader)
    shown = {}
    for i, run in enumerate(plog.runs):
        for (k, epoch), life in sorted(worker_lives(run).items()):
            cs = life["card_solves"]
            want = solve_launches(cs["solves"], cs["capacity_iters"])
            check(nonzero(life["launches"]) == nonzero(want),
                  f"{label}: run {i} worker {k} (epoch {epoch}) launched "
                  f"{life['launches']}, expected {want} for its card solves {cs}")
            check(card != "cuda" or cs["solves"] >= life["local"],
                  f"{label}: run {i} worker {k} (epoch {epoch}) reports {cs['solves']} "
                  f"card solves, its rounds {life['local']} local solves")
            if card == "cuda":
                add_launches(out, life["launches"])
            shown[f"{i}.{k}.{epoch}"] = [cs["solves"], life["local"]]
    log(f"{label}: {len(plog.runs)} replays; launches: leader {nonzero(leader)} for "
        f"{len(plog.stacked)} stacked blocks ({stacked} stacked replies); workers "
        f"(run.shard.epoch: card solves reported, local solves in its rounds) "
        + json.dumps(shown) + " (exact)")
    return out


def proc_spec(name):
    """A proc weather's spec, or a network-chaos matrix fleet point's
    (``config:seam:kind``)."""
    from evergreen_tpu_torch.scenarios import net_matrix, procs
    from evergreen_tpu_torch.scenarios.library import PROC_WEATHERS

    if ":" in name:
        config = name.split(":", 1)[0]
        return net_matrix._proc_net_spec(config, *dict(net_matrix.proc_points(config))[name])
    return (PROC_WEATHERS.get(name) or procs.PROC_SCENARIOS[name])()


def proc_workload_key(spec) -> str:
    """A proc spec's workload: its problem and solver plane (its deadlines
    change no converged state)."""
    args = next(e.args for e in spec.events if e.kind == "proc_fleet")
    return json.dumps({k: v for k, v in args.items()
                       if k not in ("round_timeout_s", "command_silence_s")}, sort_keys=True)


def proc_cpu_references() -> dict:
    """The CPU's side of step 5, which needs no card (the scenario process
    runs it before its gate): the uninterrupted reference fleet of each
    workload of ``PROC_CARD_WEATHERS`` (``_reference_canonical``), the
    crash workload's ``proc_reference_state`` and, with
    ``PROC_SELFTEST``, the proc self-test; each on the CPU, with its wall."""
    from evergreen_tpu_torch.scenarios import procs
    from evergreen_tpu_torch.scenarios.fuzz import sabotage_selftest

    out = {"workloads": {}, "walls": {}, "selftest": None}
    for name in PROC_CARD_WEATHERS + (PROC_NET_POINT,):
        spec = proc_spec(name)
        key = proc_workload_key(spec)
        if key not in out["workloads"]:
            t0 = time.perf_counter()
            out["workloads"][key] = procs._reference_canonical(spec, device="cpu")
            out["walls"][f"CPU reference of {name}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["crash"] = procs.proc_reference_state(device="cpu")
    out["walls"]["CPU crash reference"] = time.perf_counter() - t0
    if PROC_SELFTEST:
        t0 = time.perf_counter()
        out["selftest"] = sabotage_selftest(proc=True, device="cpu")
        out["walls"]["proc self-test on the CPU"] = time.perf_counter() - t0
    return out


#: ``--procs``: the candidates for the card's step 5, each timed alone
PROC_TIMING_WEATHERS = ("proc-fleet-sigkill", "proc-leader-kill-return", "leader-death",
                        "proc-net-oneway-partition", PROC_NET_POINT)


def procs_timing() -> None:
    """``chip_smoke.py --procs``: step 5 on the card with every weather of
    ``PROC_TIMING_WEATHERS`` and the proc self-test, with the CPU side
    first; each wall and supervisor start printed. Its data directories
    go under ``SCENARIO_ROOT``, removed at the end."""
    import shutil
    import tempfile

    global PROC_CARD_WEATHERS, PROC_SELFTEST
    PROC_CARD_WEATHERS = tuple(w for w in PROC_TIMING_WEATHERS if w != PROC_NET_POINT)
    PROC_SELFTEST = True
    shutil.rmtree(SCENARIO_ROOT, ignore_errors=True)
    os.makedirs(SCENARIO_ROOT)
    tempfile.tempdir = SCENARIO_ROOT
    try:
        t0 = time.perf_counter()
        cpu = proc_cpu_references()
        t1 = time.perf_counter()
        out = procs_round("cuda", cpu)
        log(f"--procs: the CPU side {t1 - t0:.1f} s, the card's {time.perf_counter() - t1:.1f} "
            f"s; walls " + json.dumps({k: round(v, 1) for k, v in
                                       {**cpu["walls"], **out["walls"]}.items()}))
    finally:
        tempfile.tempdir = None
        shutil.rmtree(SCENARIO_ROOT, ignore_errors=True)


def net_point_checks(run, entry, ref, card) -> None:
    """``PROC_NET_POINT``'s run on ``card``: ok with its three checks
    (``solver-engaged``, ``stale-accepted-zero``,
    ``degrade-within-one-round``), no stale result accepted, exactly one
    round with a solve that timed out (degraded to local) and a later
    round fully stacked, and its converged state the CPU reference's."""
    label = f"{PROC_NET_POINT} on {card}"
    check(entry["ok"], f"{label}: {failed(entry)}")
    check(sorted(entry["checks"]) == ["degrade-within-one-round", "solver-engaged",
                                      "stale-accepted-zero"]
          and all(v["ok"] for v in entry["checks"].values()),
          f"{label}: checks {entry['checks']}")
    check(entry["stats"].get("solver_stale_accepted", 0) == 0,
          f"{label}: {entry['stats'].get('solver_stale_accepted')} stale results accepted")
    timed_out = [i for i, rnd in enumerate(run.rounds)
                 if any(r.get("solve_cause") == "timeout" for r in rnd.values())]
    check(len(timed_out) == 1, f"{label}: rounds with a timed-out solve: {timed_out}")
    check(any(len(rnd) == 2 and all(r.get("solve") == "stacked" for r in rnd.values())
              for rnd in run.rounds[timed_out[0] + 1:]),
          f"{label}: no fully stacked round after the degraded round {timed_out[0]}")
    check(run.reference_canonical == ref,
          f"{label}: its converged state differs from the CPU reference")


def procs_round(card, cpu=None) -> dict:
    """Step 5: ``PROC_CARD_WEATHERS`` through ``ProcScenarioRun`` on
    ``card``, each once: ok with every invariant, check and SLO, its
    converged canonical state equal to a CPU run of its workload's
    uninterrupted reference fleet (one per workload, which is also the
    rerun side of its ``resume_equals_rerun``); then
    ``run_crash_point(*PROC_CRASH_POINT)`` on ``card`` against the CPU's
    ``proc_reference_state``, then ``PROC_NET_POINT`` (``net_point_checks``),
    and with ``PROC_SELFTEST`` the proc sabotage
    self-test on ``card``, its result equal to its CPU twin's. ``cpu`` is
    ``proc_cpu_references()``'s result (computed here when None).
    Launches held by ``proc_card_launches``. Returns the card launches
    (the kernels line's ``procs`` column), the walls and the supervisor
    starts on ``card``."""
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scenarios import procs
    from evergreen_tpu_torch.scenarios.fuzz import sabotage_selftest

    cpu = proc_cpu_references() if cpu is None else cpu
    plog = ProcLog()
    walls, totals = {}, {}

    def on_card(label, fn):
        reset_launches(fused_distro_stats, segment_sum)
        plog.clear()
        t0 = time.perf_counter()
        out = fn()
        walls[label] = time.perf_counter() - t0
        add_launches(totals, proc_card_launches(plog, card, label))
        return out

    for name in PROC_CARD_WEATHERS:
        spec = proc_spec(name)
        ref = cpu["workloads"][proc_workload_key(spec)]
        run = procs.ProcScenarioRun(spec, device=card)
        run.reference_state = ref
        entry = on_card(name, run.execute)
        check(entry["ok"], f"{name} on {card}: {failed(entry)}")
        check(run.reference_canonical == ref,
              f"{name} on {card}: its converged state differs from the CPU reference")
        st = entry["stats"]
        log(f"{name} on {card}: ok in {walls[name]:.1f} s: {st['ticks']} rounds, "
            f"restarts {st['restarts_total']}, supervisor restarts {st.get('sup_restarts', 0)}, "
            f"stacked/local replies {st.get('solver_stacked_replies', 0)}/"
            f"{st.get('solver_local_replies', 0)}; converged to the CPU reference's state")
    seam, index = PROC_CRASH_POINT
    label = f"crash point {seam}@{index}"
    res = on_card(label, lambda: procs.run_crash_point(seam, index, reference=cpu["crash"],
                                                       device=card))
    check(res["ok"] and res["parity_ok"] and res["epochs"] == [1, 2],
          f"{label} on {card}: {res['problems']}, epochs {res['epochs']}")
    log(f"{label} on {card}: ok in {walls[label]:.1f} s, epochs {res['epochs']}, resumed "
        f"to the CPU rerun's state")
    spec = proc_spec(PROC_NET_POINT)
    ref = cpu["workloads"][proc_workload_key(spec)]
    run = procs.ProcScenarioRun(spec, device=card)
    run.reference_state = ref
    entry = on_card(PROC_NET_POINT, run.execute)
    net_point_checks(run, entry, ref, card)
    st = entry["stats"]
    log(f"{PROC_NET_POINT} on {card}: ok in {walls[PROC_NET_POINT]:.1f} s: checks "
        f"{ {k: v['ok'] for k, v in entry['checks'].items()} }, stacked/local replies "
        f"{st.get('solver_stacked_replies', 0)}/{st.get('solver_local_replies', 0)}, stale "
        f"accepted {st.get('solver_stale_accepted', 0)}; rounds' solves "
        + json.dumps([[r.get("solve_cause") or r.get("solve") for _, r in sorted(rnd.items())]
                      for rnd in run.rounds])
        + "; converged to the CPU reference's state")
    if PROC_SELFTEST:
        st = on_card("proc self-test", lambda: sabotage_selftest(proc=True, device=card))
        twin = cpu["selftest"]
        check(st["ok"] and st == twin, f"proc sabotage self-test on {card}: {st}, CPU {twin}")
        log(f"proc sabotage self-test on {card}: caught {st['red']}, shrank it to "
            f"{st['shrunk_events']} events and {st['shrunk_ticks']} ticks, deterministic, "
            f"fingerprint {st['fingerprint']}, equal to its CPU twin's")
    starts = [round(s, 2) for dev, s in plog.starts if dev == ("cuda" if card == "cuda" else "cpu")]
    log(f"step 5: FleetSupervisor.start() walls on {card} (s; a replay's first boots its "
        f"workers in parallel, a successor's adopts them): {starts}; card launches "
        f"{nonzero(totals)}")
    return {"launches": totals, "walls": walls, "starts": starts}


#: the crash round (``start_crash_child``): the crash matrix's kill
#: points on the card, each against a CPU child's uninterrupted run; the
#: other ten single-store points, the other two handoff points and the
#: supervisor and solver points run on the CPU
#: (``tests/test_torch_crash_recovery.py``, ``python -m
#: evergreen_tpu_torch.scenarios.crash_matrix --device cpu``)
CRASH_CARD_POINTS = (("scheduler.solve", 2), ("dispatch.assign", 0))
CRASH_SHARDED_POINT = ("handoff.record", 0)
CRASH_ROOT = os.path.join(
    __import__("tempfile").gettempdir(),
    "evg-smoke-crash-" + __import__("hashlib").sha1(HERE.encode()).hexdigest()[:12])
CRASH_WAIT_S = 600.0


def crash_cpu_references() -> dict:
    """The crash round's CPU side, which needs no card: a CPU child's
    uninterrupted run of the single-store workload and of the 2-shard
    one (``reference_state``, ``sharded_reference_state``), with walls."""
    from evergreen_tpu_torch.scenarios import crash_matrix as cm

    out, walls = {}, {}
    t0 = time.perf_counter()
    out["single"] = cm.reference_state(device="cpu")
    walls["CPU reference"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sharded"] = cm.sharded_reference_state(device="cpu")
    walls["CPU sharded reference"] = time.perf_counter() - t0
    out["walls"] = walls
    return out


def crash_lives(label, lives, card, totals) -> list:
    """Hold each child life of a crash case: its launch lines exact
    (``life_launches``), no lock-order inversion, and on the card a card
    solve for every tick it planned on the device, at least one if it
    reported a tick; its launches added to ``totals``. Returns each
    life's (ticks, card solves, boot split, wall) for the log."""
    shown = []
    for i, life in enumerate(lives):
        check(not life["problems"], f"{label}: life {i}: {life['problems']}")
        check(life["inversions"] == 0, f"{label}: life {i}: {life['inversions']} "
              f"lock-order inversion lines")
        solves = life["card_solves"]["solves"]
        if card == "cuda":
            check(solves == life["device_ticks"] and (solves or not life["ticks"]),
                  f"{label}: life {i}: {solves} card solves for {life['device_ticks']} "
                  f"device ticks of {len(life['ticks'])} reported")
            add_launches(totals, {k: v for k, v in life["launches"].items() if v})
        shown.append({"ticks": len(life["ticks"]), "card_solves": solves,
                      "boot_ms": {k: round(v, 1) for k, v in (life["boot"] or {}).items()},
                      "wall_s": life["wall_s"]})
    return shown


def crash_round(card, cpu=None) -> dict:
    """The crash matrix on ``card`` (``scenarios/crash_matrix.py``, every
    child under the lock-order witness): the kill points of
    ``CRASH_CARD_POINTS`` (each crashed at its seam, restarted, converged
    to the CPU child's uninterrupted state, epochs [1, 2], invariants
    held), the two-process failover (the resumed holder fenced: exit 75
    or 70, the standby at a higher epoch, no superseded-epoch frame past
    the fence point) and ``CRASH_SHARDED_POINT`` on a 2-shard plane
    (converged to the CPU's 2-shard run, per-shard epochs [1, 2]); each
    child life's launches exact (``crash_lives``). ``cpu`` is
    ``crash_cpu_references()``'s result (computed here when None).
    Returns the card launches (the kernels line's ``crash`` column) and
    the walls."""
    from evergreen_tpu_torch.scenarios import crash_matrix as cm

    cpu = crash_cpu_references() if cpu is None else cpu
    walls, totals = {}, {}
    for seam, idx in CRASH_CARD_POINTS:
        label = f"crash {seam}@{idx}"
        t0 = time.perf_counter()
        out = cm.run_point(seam, idx, reference=cpu["single"], device=card)
        walls[label] = time.perf_counter() - t0
        check(out["ok"] and out["crashed"] and out["parity_ok"] and out["epochs"] == [1, 2],
              f"{label} on {card}: {out['problems']}, rc {out['rc']}, epochs "
              f"{out['epochs']}: {out['out'][-3000:]}")
        lives = crash_lives(label, out["lives"], card, totals)
        log(f"{label} on {card}: crashed (rc {out['rc']}), epochs {out['epochs']}, converged "
            f"to the CPU reference, invariants held, in {walls[label]:.1f} s; lives "
            + json.dumps(lives))
    label = "crash failover"
    t0 = time.perf_counter()
    fo = cm.failover_case(device=card)
    walls[label] = time.perf_counter() - t0
    check(fo["ok"] and fo["holder_exit"] in (cm.EXIT_LOST, cm.EXIT_FENCED)
          and fo["standby_epoch"] > fo["holder_epoch"] and not fo["stale_after_fence"],
          f"{label} on {card}: {fo['problems']}: {fo['holder_out'][-2000:]} "
          f"{fo['standby_out'][-2000:]}")
    lives = crash_lives(label, fo["lives"], card, totals)
    log(f"{label} on {card}: the resumed holder exited {fo['holder_exit']} (fenced at its "
        f"commit: {fo['fenced_at_commit']}), epochs holder {fo['holder_epoch']} standby "
        f"{fo['standby_epoch']}, frame epochs {fo['frame_epochs']}, none superseded past "
        f"the fence, in {walls[label]:.1f} s; lives " + json.dumps(lives))
    seam, idx = CRASH_SHARDED_POINT
    label = f"crash sharded {seam}@{idx}"
    t0 = time.perf_counter()
    out = cm.run_sharded_point(seam, idx, reference=cpu["sharded"], device=card)
    walls[label] = time.perf_counter() - t0
    check(out["ok"] and out["crashed"] and out["parity_ok"]
          and all(e == [1, 2] for e in out["epochs"].values()),
          f"{label} on {card}: {out['problems']}, rc {out['rc']}, epochs "
          f"{out['epochs']}: {out['out'][-3000:]}")
    lives = crash_lives(label, out["lives"], card, totals)
    log(f"{label} on {card}: crashed (rc {out['rc']}), per-shard epochs {out['epochs']}, "
        f"converged to the CPU's 2-shard run, one owner per distro, in "
        f"{walls[label]:.1f} s; lives " + json.dumps(lives))
    log(f"crash round on {card}: {sum(walls.values()):.1f} s; card launches "
        f"{nonzero(totals)} (exact per life)")
    return {"launches": totals, "walls": walls}


#: the matrices round (``matrices_round``, in the crash process after its
#: crash round): each harness a ``python -m`` child under the lock-order
#: witness, its temp dirs under ``CRASH_ROOT``; the fault matrix's async
#: WAL case, the overload matrix's threaded churn storm, the disk
#: matrix's engine points ``DISK_CARD_POINTS`` on the card against a CPU
#: run of each in the crash process, and the disk grid's
#: ``DISK_GRID_CONFIG`` config on the card machine's own filesystem (no
#: device); the other cases run on
#: the CPU (``tests/test_torch_resilience.py``,
#: ``tests/test_torch_overload_matrix.py``, ``tests/test_torch_disk_matrix.py``)
MATRIX_FAULT_CASE = "wal-async-deferred"
MATRIX_OVERLOAD_CASE = "task-churn-storm"
DISK_CARD_POINTS = ("wal:enospc", "wal:eio", "wal:bitrot", "wal:short",
                    "snapshot:enospc", "snapshot:eio", "snapshot:bitrot", "snapshot:short")
DISK_GRID_CONFIG = "classic"
MATRIX_WAIT_S = 300.0


def matrix_child(module, args, card) -> dict:
    """``python -m evergreen_tpu_torch.scenarios.<module> ARGS --device
    CARD`` with the witness on (so it needs no re-execution) and its temp
    dirs under ``CRASH_ROOT``: its exit code, wall, ``TICKS`` lines and
    JSON lines; held to exit 0 and no lock-order inversion (its own audit
    line and the witness's stderr lines)."""
    from evergreen_tpu_torch.scenarios import crash_matrix as cm

    env = {**os.environ, "EVG_FAULTS": "", "TMPDIR": CRASH_ROOT,
           "EVERGREEN_TPU_LOCKCHECK": os.environ.get("EVERGREEN_TPU_LOCKCHECK") or "1"}
    label = f"{module} {' '.join(args)} on {card}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"evergreen_tpu_torch.scenarios.{module}", *args,
         "--device", card], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=MATRIX_WAIT_S)
    wall = time.perf_counter() - t0
    out = proc.stdout.decode(errors="replace")
    ticks, lines = [], []
    for line in out.splitlines():
        if line.startswith("TICKS "):
            ticks.append(json.loads(line[len("TICKS "):]))
        elif line.startswith("{"):
            lines.append(json.loads(line))
    audit = [x["lockcheck_inversions"] for x in lines if "lockcheck_inversions" in x]
    witnessed = sum(line.startswith("lockcheck: ORDER INVERSION")
                    for line in out.splitlines())
    check(proc.returncode == 0, f"{label}: exit code {proc.returncode}: {out[-4000:]}")
    check(audit == [0] and witnessed == 0,
          f"{label}: lock-order inversions {audit}, {witnessed} witness lines: {out[-3000:]}")
    for t in ticks:
        check(not t["problems"], f"{label}: {t.get('case') or t.get('point')}: "
              f"{t['problems']}")
        if card == "cuda":
            cs = t["card_solves"]
            want = nonzero(cm.expected_launches(cs["solves"], cs["capacity_iters"]))
            check(t["launches"] == want, f"{label}: launches {t['launches']}, expected "
                  f"{want} for card solves {cs}")
            check(t["device_ticks"] is None or cs["solves"] == t["device_ticks"],
                  f"{label}: {cs['solves']} card solves for {t['device_ticks']} device ticks")
    return {"wall": wall, "ticks": ticks, "lines": lines, "out": out}


def matrix_runs(card, net=False) -> dict:
    """The round's three children on ``card``: the fault case and the disk
    grid's ``DISK_GRID_CONFIG`` points with the engine points at once
    (neither reads wall time), with ``net`` the net round's child beside
    them (its checks only bound wall time from below), then the overload
    case alone (its ``max_pending`` and ``peaked`` read wall time).
    ``"wall"``: the round's; ``"net"``: the net child's run (or None)."""
    from concurrent.futures import ThreadPoolExecutor

    disk_args = ["--grid-only", "--config", DISK_GRID_CONFIG, "--engine-only"] + [
        a for p in DISK_CARD_POINTS for a in ("--engine-point", p)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        fault = pool.submit(matrix_child, "fault_matrix",
                            ["--seeds", "1", "--case", MATRIX_FAULT_CASE], card)
        disk = pool.submit(matrix_child, "disk_matrix", disk_args, card)
        beside = pool.submit(matrix_child, "net_matrix", list(NET_ARGS), card) if net else None
        runs = {"fault": fault.result(), "disk": disk.result()}
        net_run = beside.result() if net else None
    runs["overload"] = matrix_child("overload_matrix",
                                    ["--seeds", "1", "--case", MATRIX_OVERLOAD_CASE], card)
    return {"runs": runs, "net": net_run, "wall": time.perf_counter() - t0}


def matrices_cpu_references() -> dict:
    """The matrices round's CPU side, which needs no card, in this process
    (no child's start to pay; the harnesses' own lines kept out of the
    log): the fault case's and the churn storm's ticks and each of
    ``DISK_CARD_POINTS``' verdicts and counters, as their ``TICKS`` lines
    give them, with walls."""
    import contextlib
    import io

    from evergreen_tpu_torch.scenarios import disk_matrix as dm
    from evergreen_tpu_torch.scenarios import fault_matrix as fm
    from evergreen_tpu_torch.scenarios import overload_matrix as om

    def as_line(d):
        return json.loads(json.dumps(d, default=str))

    out, walls = {}, {}
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        case = fm.run_case(MATRIX_FAULT_CASE, 0, device="cpu")
        check(case["ok"], f"fault {MATRIX_FAULT_CASE} on cpu: "
              f"{ {k: v for k, v in case.items() if k != 'logs'} }")
        out["fault"] = {"ticks": [as_line({k: case[k] for k in ("degraded", "planners",
                                                                "queues")})]}
        walls["matrices CPU fault"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        case = om.run_case(MATRIX_OVERLOAD_CASE, 0, device="cpu")
        check(case["ok"], f"overload {MATRIX_OVERLOAD_CASE} on cpu: "
              f"{ {k: v for k, v in case.items() if k not in ('logs', 'queues')} }")
        out["overload"] = {"ticks": [as_line({k: case[k] for k in ("planners", "queues")})]}
        walls["matrices CPU overload"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        points = [dm.run_engine_point(p, device="cpu") for p in DISK_CARD_POINTS]
        check(all(r["ok"] for r in points), "disk engine on cpu: "
              + json.dumps([r["problems"] for r in points])[:3000])
        out["disk"] = {"ticks": [as_line(r["ticks"]) for r in points]}
        walls["matrices CPU disk"] = time.perf_counter() - t0
    out["walls"] = walls
    return out


def matrices_round(card, cpu=None, net=False) -> dict:
    """The fault, overload and disk matrices on ``card``
    (``scenarios/fault_matrix.py``, ``overload_matrix.py``,
    ``disk_matrix.py``, each child under the lock-order witness):
    ``MATRIX_FAULT_CASE`` (degraded "", then persist-failed, then "", the
    third tick's queues the CPU's, every tick planned on the card),
    ``MATRIX_OVERLOAD_CASE`` (ok, every planning tick planned on the card
    with the CPU's queues of the same index), each of ``DISK_CARD_POINTS``
    (ok, its verdicts and counters the CPU's, every tick on the card) and
    the grid's ``DISK_GRID_CONFIG`` points (ok, each one's wall); every
    child's launches exact for its card solves. ``cpu`` is
    ``matrices_cpu_references()``'s result (computed here when None).
    With ``net``, the net round's child runs beside the fault and disk
    children (``matrix_runs``). Returns the card launches (the kernels
    line's ``matrices`` column), the walls and the net child's run."""
    cpu = matrices_cpu_references() if cpu is None else cpu
    children = matrix_runs(card, net)
    runs = children["runs"]
    totals = {}
    for run in runs.values():
        for t in run["ticks"]:
            add_launches(totals, t["launches"])
    walls = {f"matrices {k}": v["wall"] for k, v in runs.items()}
    walls["matrices round"] = children["wall"]

    label = f"fault {MATRIX_FAULT_CASE} on {card}"
    (ticks,), (cticks,) = runs["fault"]["ticks"], cpu["fault"]["ticks"]
    check({"case": MATRIX_FAULT_CASE, "seed": 0, "ok": True} in runs["fault"]["lines"],
          f"{label}: {runs['fault']['out'][-3000:]}")
    check(ticks["degraded"] == ["", "persist-failed", ""],
          f"{label}: degraded {ticks['degraded']}")
    check(ticks["planners"] == ["tpu"] * 3, f"{label}: planners {ticks['planners']}")
    check(ticks["queues"] == cticks["queues"], f"{label}: the third tick's queues differ "
          f"from the CPU's")
    log(f"{label}: degraded {ticks['degraded']}, planners {ticks['planners']}, the third "
        f"tick's {len(ticks['queues'])} queues the CPU's; card solves "
        f"{ticks['card_solves']}, launches {ticks['launches']} (exact), in "
        f"{runs['fault']['wall']:.1f} s")

    label = f"overload {MATRIX_OVERLOAD_CASE} on {card}"
    (ticks,), (cticks,) = runs["overload"]["ticks"], cpu["overload"]["ticks"]
    case = next(x for x in runs["overload"]["lines"] if x.get("case") == MATRIX_OVERLOAD_CASE)
    shown = {k: case.get(k) for k in ("max_pending", "peaked", "evals_to_green", "shed")}
    check(case["ok"], f"{label}: {case} (max_pending and peaked read wall time)")
    check(ticks["planners"] == ["tpu"] * len(ticks["planners"]) and ticks["planners"],
          f"{label}: planners {ticks['planners']}")
    check(ticks["queues"] == cticks["queues"],
          f"{label}: a planning tick's queues differ from the CPU's tick of the same index")
    log(f"{label}: ok {shown}; {len(ticks['planners'])} planning ticks planned on "
        f"{card}, each with the CPU's queues; card solves {ticks['card_solves']}, launches "
        f"{ticks['launches']} (exact), in {runs['overload']['wall']:.1f} s")

    label = f"disk engine on {card}"
    cpu_points = {t["point"]: t for t in cpu["disk"]["ticks"]}
    for t in runs["disk"]["ticks"]:
        c = cpu_points[t["point"]]
        check(t["planners"] == ["tpu"] * len(t["planners"]),
              f"{label} {t['point']}: planners {t['planners']}")
        check(t["verdicts"] == c["verdicts"] and t["counters"] == c["counters"],
              f"{label} {t['point']}: verdicts {t['verdicts']} counters {t['counters']} "
              f"against the CPU's {c['verdicts']} {c['counters']}")
    oks = {x["point"]: x["ok"] for x in runs["disk"]["lines"] if x.get("arm") == "engine"}
    check(sorted(oks) == sorted(DISK_CARD_POINTS) and all(oks.values()),
          f"{label}: {oks}: {runs['disk']['out'][-3000:]}")
    log(f"{label}: {len(oks)} points ok, verdicts and counters the CPU's: "
        + json.dumps({t["point"]: {"card_solves": t["card_solves"]["solves"],
                                   "wall_s": t["wall_s"]} for t in runs["disk"]["ticks"]}))
    grid = [x for x in runs["disk"]["lines"] if x.get("arm") == "grid"]
    check(len(grid) == 14 and all(g["ok"] for g in grid),
          f"disk grid {DISK_GRID_CONFIG} on the card machine: "
          + json.dumps([g for g in grid if not g["ok"]])[:3000])
    walls[f"matrices disk grid {DISK_GRID_CONFIG}"] = sum(g["wall_s"] for g in grid)
    log(f"disk grid {DISK_GRID_CONFIG} under {CRASH_ROOT} ({mount_of(CRASH_ROOT)}): "
        f"{len(grid)} points ok; walls (s) "
        + json.dumps({g["point"]: g["wall_s"] for g in grid}))
    log(f"matrices round on {card}: {children['wall']:.1f} s (the fault and disk children "
        f"{'and the net child ' if net else ''}at once, then the overload child); card "
        f"launches {nonzero(totals)} (exact per case)")
    return {"launches": totals, "walls": walls, "net": children["net"]}


#: the net round (``net_round``, in the crash process, its child beside
#: the matrices round's fault and disk children): the network-chaos
#: matrix's classic grid on the card, a ``python -m`` child under the
#: witness; its fleet points boot proc
#: workers (14-34 s each on the card), so one of them runs in step 5
#: (``PROC_NET_POINT``) and the rest on the CPU
#: (``tests/test_torch_net_matrix*.py``)
NET_ARGS = ("--grid-only", "--config", "classic")


def net_cpu_references() -> dict:
    """The net round's CPU side, which needs no card, in this process (the
    harness's own lines kept out of the log): the sabotage's verdicts and
    each classic point's ``ok``, verdicts and fingerprint, in the child's
    order after the mock cloud's reset (a fresh process's), with the
    wall."""
    import contextlib
    import io

    from evergreen_tpu_torch.cloud.mock import MockCloudManager
    from evergreen_tpu_torch.scenarios import net_matrix as nm

    t0 = time.perf_counter()
    MockCloudManager.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        (sab,) = nm.run_sabotage(device="cpu")
        check(sab["ok"], f"net sabotage on cpu: {sab['problems']}")
        points = {}
        for point, factory in nm.classic_points():
            entry, line = nm.run_engine("grid", point, factory(), device="cpu")
            points[point] = {"ok": bool(entry["ok"]) and not line["problems"],
                             "verdicts": line["verdicts"],
                             "fingerprint": line["fingerprint"]}
            check(points[point]["ok"], f"net {point} on cpu: {line['problems']} "
                  f"{failed(entry)}")
    MockCloudManager.reset()
    return {"sabotage": sab["verdicts"], "points": points,
            "walls": {"net CPU": time.perf_counter() - t0}}


def net_round(card, cpu=None, run=None) -> dict:
    """The network-chaos matrix on ``card`` (``scenarios/net_matrix.py``
    ``NET_ARGS``, a child under the lock-order witness): its sabotage red
    with the CPU's verdicts, each classic point ok with the CPU's
    verdicts and fingerprint, every tick planned on the card, launches
    exact for each point's card solves, no inversion (``matrix_child``).
    ``cpu`` is ``net_cpu_references()``'s result (computed here when
    None); ``run`` the child's run where it ran already (beside the
    matrices round's children), else it runs here. Returns the card
    launches (the kernels line's ``net`` column) and the walls."""
    cpu = net_cpu_references() if cpu is None else cpu
    run = matrix_child("net_matrix", list(NET_ARGS), card) if run is None else run
    label = f"net matrix {' '.join(NET_ARGS)} on {card}"
    results = {x["point"]: x for x in run["lines"] if "arm" in x}
    ticks = {t["point"]: t for t in run["ticks"]}
    sab = results.get("unfenced-duplicate", {})
    check(sab.get("ok") and sab.get("verdicts") == cpu["sabotage"],
          f"{label}: the sabotage {sab} against the CPU's verdicts {cpu['sabotage']}")
    check(sorted(ticks) == sorted(["unfenced-duplicate", *cpu["points"]])
          and sorted(results) == sorted(ticks),
          f"{label}: lines for {sorted(results)}, TICKS for {sorted(ticks)}")
    totals = {}
    for point, want in cpu["points"].items():
        t = ticks[point]
        check(results[point]["ok"], f"{label}: {point}: {results[point]['problems']}")
        check(t["planners"] == ["tpu"] * len(t["planners"]) and t["planners"],
              f"{label}: {point}: planners {t['planners']}")
        check(t["verdicts"] == want["verdicts"] and t["fingerprint"] == want["fingerprint"],
              f"{label}: {point}: verdicts {t['verdicts']} fingerprint {t['fingerprint']} "
              f"against the CPU's {want['verdicts']} {want['fingerprint']}")
    for t in run["ticks"]:
        add_launches(totals, t["launches"])
    log(f"{label}: the sabotage red with the CPU's verdicts; {len(cpu['points'])} classic "
        f"points ok, verdicts and fingerprints the CPU's, every tick planned on {card}: "
        + json.dumps({p: {"card_solves": ticks[p]["card_solves"]["solves"],
                          "wall_s": ticks[p]["wall_s"]} for p in ticks})
        + f"; launches {nonzero(totals)} (exact per point), in {run['wall']:.1f} s")
    return {"launches": totals, "walls": {"net": run["wall"]}}


def crash_child(here, out_path, t0_wall, gate, card="cuda") -> None:
    """The ``spawn`` process of ``start_crash_child``: the CPU references
    (``crash_cpu_references``, ``matrices_cpu_references``,
    ``net_cpu_references``), then, once ``gate`` is set (after the fleet
    process's join), ``crash_round``, ``matrices_round`` and ``net_round``
    on ``card``, their data directories under ``CRASH_ROOT``; writes
    ``{"ok": ..., the launches of each round ("launches", "matrices",
    "net") and the walls, or "error"}`` to ``out_path``."""
    global _T0, _TAG
    _T0 = time.perf_counter() - (time.time() - t0_wall)
    _TAG = "[crash process] "
    sys.path.insert(0, here)
    # a terminate (a failure elsewhere) unwinds: the running child is
    # killed on the way out
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
    result = {"ok": False}
    import shutil
    import tempfile

    shutil.rmtree(CRASH_ROOT, ignore_errors=True)
    os.makedirs(CRASH_ROOT)
    tempfile.tempdir = CRASH_ROOT
    try:
        t0 = time.perf_counter()
        cpu = crash_cpu_references()
        log(f"the crash round's CPU references in {time.perf_counter() - t0:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in cpu["walls"].items()}))
        t0 = time.perf_counter()
        mcpu = matrices_cpu_references()
        log(f"the matrices round's CPU references in {time.perf_counter() - t0:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in mcpu["walls"].items()}))
        ncpu = net_cpu_references()
        log(f"the net round's CPU references in {ncpu['walls']['net CPU']:.1f} s")
        t1 = time.perf_counter()
        gate.wait()
        log(f"waited {time.perf_counter() - t1:.1f} s for the fleet process's end")
        out = crash_round(card, cpu)
        matrices = matrices_round(card, mcpu, net=True)
        net = net_round(card, ncpu, matrices["net"])
        result.update(out, ok=True, matrices=matrices["launches"], net=net["launches"])
        result["walls"] = {**cpu["walls"], **out["walls"], **mcpu["walls"],
                           **matrices["walls"], **ncpu["walls"], **net["walls"]}
    except BaseException:
        import traceback

        result["error"] = traceback.format_exc()
        raise
    finally:
        tempfile.tempdir = None
        shutil.rmtree(CRASH_ROOT, ignore_errors=True)
        with open(out_path, "w") as fh:
            json.dump(result, fh)


def start_crash_child(card="cuda") -> dict:
    """``crash_child`` in a ``spawn`` process, with the event it waits
    for before it touches the card (``"gate"``, set once the fleet
    process has ended)."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    out_path = os.path.join(tempfile.mkdtemp(prefix="evg-chip-crash-"), "result.json")
    t0_wall = time.time() - (time.perf_counter() - _T0)
    gate = ctx.Event()
    proc = ctx.Process(target=crash_child, args=(HERE, out_path, t0_wall, gate, card))
    proc.start()
    return {"proc": proc, "gate": gate, "out": out_path, "t0": time.perf_counter(),
            "card": card}


def join_crash_child(child) -> dict:
    """Wait for the crash process; its result, or the failure it wrote."""
    import shutil

    proc = child["proc"]
    t0 = time.perf_counter()
    proc.join(CRASH_WAIT_S)
    waited = time.perf_counter() - t0
    if proc.is_alive():
        stop_fleet_child(child)
    result = {}
    if os.path.exists(child["out"]):
        with open(child["out"]) as fh:
            result = json.load(fh)
    shutil.rmtree(os.path.dirname(child["out"]), ignore_errors=True)
    check(proc.exitcode == 0 and result.get("ok"),
          f"the crash process ended with exit code {proc.exitcode}: "
          f"{result.get('error', '')[-3000:]}")
    log(f"the crash process ended {time.perf_counter() - child['t0']:.1f} s after its "
        f"start; waited {waited:.1f} s for it here; its walls "
        + json.dumps({k: round(v, 1) for k, v in result["walls"].items()}))
    return result


def fleet_crash(n) -> None:
    """``chip_smoke.py --fleet-crash N``: phase 10's durable fleet
    (``fleet_phase``) N times on the card, with the crash process's
    round beside them, its gate open from the start: a run's conditions
    when the crash children boot beside the fleet's rounds. A fleet's
    failure is printed (with the documents that differ and each shard's
    tick ms, overload, shed and degradation) and the next one runs; each
    round's line holds its shards' readings."""
    import shutil

    import numpy as np
    import torch

    from evergreen_tpu_torch.utils.benchgen import generate_problem

    problem = generate_problem(*CONFIG3, seed=SEED)
    keep = {d.id for d in problem[0][:-1]}
    crash = start_crash_child()
    crash["gate"].set()
    ok = 0
    try:
        for i in range(n):
            shutil.rmtree(FLEET_ROOT, ignore_errors=True)
            os.makedirs(FLEET_ROOT)
            t0 = time.perf_counter()
            try:
                fleet_phase(torch, np, problem, keep, "cuda",
                            os.path.join(FLEET_ROOT, "durable-fleet"), {"fleet": {}})
                ok += 1
                log(f"--fleet-crash {i}: ok in {time.perf_counter() - t0:.1f} s")
            except AssertionError as exc:
                log(f"--fleet-crash {i}: FAILED in {time.perf_counter() - t0:.1f} s: {exc}")
            finally:
                shutil.rmtree(FLEET_ROOT, ignore_errors=True)
        join_crash_child(crash)
    finally:
        stop_fleet_child(crash)
    log(f"--fleet-crash {n}: {ok} of {n} fleets ok")
    check(ok == n, f"--fleet-crash: {ok} of {n} fleets ok")


def matrices_alone() -> None:
    """``chip_smoke.py --matrices``: the matrices round alone on the card,
    its CPU side first, each wall printed."""
    import shutil

    shutil.rmtree(CRASH_ROOT, ignore_errors=True)
    os.makedirs(CRASH_ROOT)
    try:
        cpu = matrices_cpu_references()
        out = matrices_round("cuda", cpu)
        log("--matrices: walls " + json.dumps(
            {k: round(v, 1) for k, v in {**cpu["walls"], **out["walls"]}.items()}))
    finally:
        shutil.rmtree(CRASH_ROOT, ignore_errors=True)


def net_alone() -> None:
    """``chip_smoke.py --net``: the net round alone on the card, its CPU
    side first, each wall printed."""
    import shutil

    shutil.rmtree(CRASH_ROOT, ignore_errors=True)
    os.makedirs(CRASH_ROOT)
    try:
        cpu = net_cpu_references()
        out = net_round("cuda", cpu)
        log("--net: walls " + json.dumps(
            {k: round(v, 1) for k, v in {**cpu["walls"], **out["walls"]}.items()}))
    finally:
        shutil.rmtree(CRASH_ROOT, ignore_errors=True)


def crash_alone() -> None:
    """``chip_smoke.py --crash``: the crash round alone on the card, its
    CPU side first, each wall printed."""
    import shutil
    import tempfile

    shutil.rmtree(CRASH_ROOT, ignore_errors=True)
    os.makedirs(CRASH_ROOT)
    tempfile.tempdir = CRASH_ROOT
    try:
        cpu = crash_cpu_references()
        out = crash_round("cuda", cpu)
        log("--crash: walls " + json.dumps(
            {k: round(v, 1) for k, v in {**cpu["walls"], **out["walls"]}.items()}))
    finally:
        tempfile.tempdir = None
        shutil.rmtree(CRASH_ROOT, ignore_errors=True)


#: the longest step 5 waits for phase 11's prime round (the fleet process
#: sets the event after that round, or when it ends)
PRIMED_WAIT_S = 300.0


def scenario_phases(torch, np, card="cuda", root=SCENARIO_ROOT, trace_ready=None,
                    trace_out=None, quiet=None, proc_cpu=None, primed=None) -> dict:
    """The scenario process's work on ``card`` (``card="cpu"`` rehearses
    it: the card's runs then run on the CPU, launch counts 0): a warm-up
    solve at a weather's dims, then steps 1-4 (``weather_round``,
    ``fuzz_round``, ``failover_round``, ``trace_round``). The engine's
    temporary data directories go under ``root``; the trace file stays
    there for phase 13 (``trace_out`` receives its path, ``trace_ready``
    is set); then, once ``primed`` is set (phase 11's prime round is
    done: step 5's worker processes must not boot beside its cold solves
    and their 10 s deadline), step 5, the process backend
    (``procs_round``, against ``proc_cpu``, ``proc_cpu_references()``'s
    result, computed there when None), and, once ``quiet`` is set (``main`` has ended phase 13),
    ``timed_round``.
    Returns the card launches of steps 1-4 and of the timed case, those
    of step 5 (``"procs"``), the walls and step 5's supervisor starts."""
    import shutil
    import tempfile

    from evergreen_tpu_torch.ops.solve import run_solve_packed
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.utils.benchgen import NOW, generate_problem

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tempfile.tempdir = root
    with open(os.path.join(HERE, "SCORECARD_GREEN.json")) as fh:
        green = json.load(fh)["scenarios"]
    with open(os.path.join(HERE, "FUZZCARD_GREEN.json")) as fh:
        start_seed = json.load(fh)["engine"]["start_seed"]
    t0 = time.perf_counter()
    run_solve_packed(build_snapshot(*generate_problem(3, 60, seed=7, hosts_per_distro=2),
                                    NOW), device=card)
    walls = {"warm-up solve": time.perf_counter() - t0}
    solves, totals = SolveLog(), {}
    t0 = time.perf_counter()
    weather_round(card, solves, totals, green)
    walls["weathers"] = time.perf_counter() - t0
    walls.update(fuzz_round(card, solves, totals, start_seed))
    walls.update({f"config3-failover {k}": v
                  for k, v in failover_round(card, solves, totals).items()})
    path, walls["trace"] = trace_round(card, solves, totals, root)
    if trace_out is not None:
        trace_out["path"] = path
    if trace_ready is not None:
        trace_ready.set()
    if primed is not None:
        t0 = time.perf_counter()
        primed.wait(PRIMED_WAIT_S)
        walls["wait for phase 11's prime round"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    procs = procs_round(card, proc_cpu)
    walls["procs"] = time.perf_counter() - t0
    walls.update({f"procs: {k}": v for k, v in procs["walls"].items()})
    if quiet is not None:
        t0 = time.perf_counter()
        quiet.wait()
        walls["wait for phase 13's end"] = time.perf_counter() - t0
    walls["timed"] = timed_round(card, solves, totals)
    return {"launches": totals, "walls": walls, "procs": procs["launches"],
            "proc_starts": procs["starts"]}


def scenario_child(here, out_path, t0_wall, gate, trace_ready, quiet, card="cuda",
                   primed=None) -> None:
    """The ``spawn`` process of ``start_scenario_child``: its imports, the
    packer's check (``packer_phase``) and step 5's CPU side
    (``proc_cpu_references``), then, once ``gate`` is set,
    ``scenario_phases`` on ``card``; its lines
    tagged and on the script's clock; writes ``{"ok": ..., the launches,
    walls and trace path, or "error"}`` to ``out_path``."""
    global _T0, _TAG
    _T0 = time.perf_counter() - (time.time() - t0_wall)
    _TAG = "[scenario process] "
    sys.path.insert(0, here)
    result = {"ok": False}
    try:
        import numpy as np
        import torch

        import evergreen_tpu_torch.scenarios  # noqa: F401
        from evergreen_tpu_torch.ops import _build
        from evergreen_tpu_torch.utils.benchgen import generate_problem

        # the packer's check and step 5's CPU side need no card: run them
        # while the gate is shut
        t0 = time.perf_counter()
        result["packer"] = packer_phase(np, generate_problem(*CONFIG3, seed=SEED))
        proc_cpu = proc_cpu_references()
        t1 = time.perf_counter()
        log(f"the packer's check and step 5's CPU references in {t1 - t0:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in proc_cpu["walls"].items()}))
        gate.wait()
        log(f"imported and ran them, then waited {time.perf_counter() - t1:.1f} s for "
            f"phase 9's profiled round")
        if card == "cuda":
            torch.cuda.set_device(0)
            _build.build(("distro_stats", "segment_sum"))  # phase 1 built them: loads
        trace_out = {}
        result.update(scenario_phases(torch, np, card=card, trace_ready=trace_ready,
                                      trace_out=trace_out, quiet=quiet, proc_cpu=proc_cpu,
                                      primed=primed),
                      trace=trace_out.get("path"), ok=True)
    except BaseException:
        import traceback

        result["error"] = traceback.format_exc()
        raise
    finally:
        trace_ready.set()
        with open(out_path, "w") as fh:
            json.dump(result, fh)


def start_scenario_child(card="cuda", primed=None) -> dict:
    """``scenario_child`` in a ``spawn`` process, with the event it waits
    for before it touches the card (``"gate"``, set with the fleet
    process's), the one it sets once step 4's trace file is written
    (``"trace_ready"``) and the one it waits for before its timed case
    (``"quiet"``); before step 5 it waits for ``primed`` where given (the
    fleet process's, ``start_fleet_child``); ``card="cpu"`` rehearses it
    on the CPU."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    out_path = os.path.join(tempfile.mkdtemp(prefix="evg-chip-scenarios-"), "result.json")
    t0_wall = time.time() - (time.perf_counter() - _T0)
    gate, trace_ready, quiet = ctx.Event(), ctx.Event(), ctx.Event()
    proc = ctx.Process(target=scenario_child,
                       args=(HERE, out_path, t0_wall, gate, trace_ready, quiet, card,
                             primed))
    proc.start()
    return {"proc": proc, "gate": gate, "trace_ready": trace_ready, "quiet": quiet,
            "out": out_path, "t0": time.perf_counter(), "card": card}


def join_scenario_child(child) -> dict:
    """Wait for the scenario process; its result, or the failure it
    wrote. The trace file's directory stays until ``remove_scenario_root``."""
    import shutil

    proc = child["proc"]
    t0 = time.perf_counter()
    proc.join(SCENARIO_WAIT_S)
    waited = time.perf_counter() - t0
    if proc.is_alive():
        stop_fleet_child(child)
    result = {}
    if os.path.exists(child["out"]):
        with open(child["out"]) as fh:
            result = json.load(fh)
    shutil.rmtree(os.path.dirname(child["out"]), ignore_errors=True)
    check(proc.exitcode == 0 and result.get("ok"),
          f"the scenario process ended with exit code {proc.exitcode}: "
          f"{result.get('error', '')[-3000:]}")
    log(f"the scenario process ended {time.perf_counter() - child['t0']:.1f} s after its "
        f"start; waited {waited:.1f} s for it here; its walls "
        + json.dumps({k: round(v, 1) for k, v in result["walls"].items()}))
    return result


def start_replay(trace_path, card="cuda", out_spec=None) -> dict:
    """``python -m evergreen_tpu_torch replay-trace TRACE`` as a process
    (``--no-run --out SPEC`` with ``out_spec``: a compile only), its
    output into unnamed files."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    argv = [sys.executable, "-m", "evergreen_tpu_torch", "replay-trace", trace_path]
    if out_spec is not None:
        argv += ["--no-run", "--out", out_spec]
    elif card != "cuda":
        argv += ["--device", "cpu"]
    return {"proc": subprocess.Popen(argv, stdout=out, stderr=err, text=True, cwd=HERE,
                                     env=dict(os.environ, PYTHONPATH=HERE)),
            "out": out, "err": err, "t0": time.perf_counter(), "card": card,
            "spec": out_spec}


def stop_replay(replay) -> None:
    if replay is not None and replay["proc"].poll() is None:
        replay["proc"].kill()
        replay["proc"].wait(timeout=30)


def join_replay(replay) -> tuple:
    """Wait for a ``replay-trace`` process: exit 0; a compile holds its
    spec file, a replay prints ``ok`` and ``deterministic`` and, on the
    card, launches exact for the device solves it prints: some with the
    capacity page, the rest without. Returns (its stdout lines, its
    launches, its wall)."""
    from evergreen_tpu_torch.settings import CapacityConfig

    proc = replay["proc"]
    rc = proc.wait(timeout=SMOKE_WAIT_S)
    wall_s = time.perf_counter() - replay["t0"]
    replay["out"].seek(0)
    replay["err"].seek(0)
    out, err = replay["out"].read().splitlines(), replay["err"].read()
    replay["out"].close()
    replay["err"].close()
    check(rc == 0, f"replay-trace exited {rc}: {' | '.join(out[-8:])} {err[-1500:]}")
    launches = {}
    if replay["spec"] is not None:
        check(out == [f"spec -> {replay['spec']}"], f"replay-trace --no-run printed {out}")
        return out, launches, wall_s
    body = json.loads("\n".join(x for x in out if not x.startswith(
        ("device solves: ", "kernel launches: "))))
    check(body["ok"] and body["deterministic"], f"replay-trace: {body}")
    if replay["card"] == "cuda":
        n = int(next(x for x in out if x.startswith("device solves: ")).split()[-1])
        launches = json.loads(next(x for x in out if x.startswith("kernel launches: "))
                              [len("kernel launches: "):])
        iters = CapacityConfig().iterations
        fits = [k for k in range(n + 1)
                if expected_launches([iters] * k + [0] * (n - k)) == launches]
        check(n > 0 and fits, f"replay-trace: launches {launches} fit no {n} solves")
    return out, launches, wall_s


#: phase 12: the job plane. Cron rounds of (a) the card's environment and
#: (b) the CPU's, each on a copy of one seeded durable directory; the
#: agent pass follows round ``CRON_AGENT_AFTER`` (1-based): over HTTP
#: against (a)'s REST surface, through ``LocalCommunicator`` on (b). The
#: fourth round ticks what the ingestion jobs of the third made
CRON_ROUNDS = 4
CRON_AGENT_AFTER = 2
CRON_ENVS = (("a", "cuda"), ("b", "cpu"))
#: the seed's tasks in flight when the pass comes: the version with the
#: most tasks in the first distro, up to this many of its tasks
#: dispatched to as many free hosts of their distro; the version's
#: parser project runs a shell echo, and every ``CRON_BOOM_EVERY``-th of
#: its tasks exits 9
CRON_IN_FLIGHT = 16
CRON_BOOM_EVERY = 4
CRON_PROJECT = {
    "tasks": {
        "echo": {"commands": [{"command": "shell.exec",
                               "params": {"script": "echo ran ${task_id} on ${distro_arch}"}}]},
        "boom": {"commands": [{"command": "shell.exec",
                               "params": {"script": "echo failing ${task_id}; exit 9"}}]},
    },
    "expansions": {"branch": "main"},
}
#: the pool round's concurrent HTTP burst: this many agent threads, each
#: running ``Agent.run_once(wait_s=BURST_WAIT_S)`` for its share of the
#: first ``BURST_HOSTS`` free hosts in id order (capped at 32: the
#: ingested tasks the burst runs fork a shell each from this large
#: process, and 64 of them took 15.2 s on an NVIDIA H100 80GB HBM3 host
#: at 700.00 W against 3.2 s for 32 tasks without commands)
BURST_THREADS = 64
BURST_HOSTS = 32
#: the free hosts, in id order, that pull in phase 12's agent pass (4,064
#: were free at config 3, and their pulls over HTTP took 25.3 s of the
#: phase's 91.1 s on an NVIDIA H100 80GB HBM3 host at 700.00 W; a quarter
#: of them measure the same rate and hold the same pairs: cut to make room
#: for the crash process's matrices round beside the phase)
PASS_PULLS = 1024
BURST_WAIT_S = 2.0
#: the REST surface's route classes, for the request timings
ROUTE_CLASSES = (("next_task", "/agent/next_task"), ("task_config", "/agent/task_config/"),
                 ("start", "/agent/start"), ("heartbeat", "/agent/heartbeat"),
                 ("end", "/agent/end"), ("logs", "/agent/logs"))
#: what two environments cannot agree on in a document beside the span
#: masks: the process's resource readings of a system-stats sample, the
#: wall times a tick's runtime-stats log record carries, and the gauges
#: an overload-level record carries (the WAL flusher's backlog and the
#: commit latency's moving average, both read off the wall clock)
CRON_MASKS = {"system_stats": ("max_rss_kb", "cpu_user_s"),
              "log_lines": SPAN_TIME_ATTRS + ("gauges",)}


#: the overload ladder's rungs for the signals read off the wall clock and
#: the disk (the WAL flusher's backlog, the commit latency, the tick's
#: lag, and the REST surface's request rate, which only (a) feeds: (b)'s
#: pass goes through ``LocalCommunicator``) set to 0, which disables
#: them, for the compared rounds: at
#: config 3 a round's writers queue enough frames for the flusher's
#: backlog to reach BLACK in one environment and not the other, and
#: BLACK sheds and defers jobs. The job queue's depth, deterministic
#: under one worker, still drives it; the phase prints each round's peak
#: backlog. The pool's round runs the default ladder
CRON_OVERLOAD = dict(wal_backlog_levels=[0, 0, 0], store_latency_ms_levels=[0, 0, 0],
                     tick_lag_levels_s=[0, 0, 0], api_rps_levels=[0, 0, 0])
#: the populators that defer their batch on the ladder (``_defer_for_overload``)
CRON_DEFERRERS = ("host-monitoring", "host-reconcile", "stats")


#: phase 12's ingestion (``ingestion/``): a project in the shape of a large
#: monorepo's, generated from the seed (``ingest_project``): one build
#: variant per config-3 distro (``run_on: [dNNN]``), each listing the same
#: ``INGEST_TASK_DEFS`` task definitions through names, tag selectors and a
#: task group (10,000 tasks a version at 200 distros), with dependency
#: chains, a task group with ``max_hosts``, a display task, ``batchtime``
#: on ``INGEST_BATCHTIME`` variants, and one generator task whose
#: ``generate.tasks`` payload adds two tasks to ``INGEST_GEN_VARIANTS``
#: variants; the polled commit's revision adds a 2 × 2 matrix (a pushed
#: revision with it would hold 204 variants, past ``generate.tasks``'s
#: limit of 200 for the whole grown project, as in the JAX package).
#: Before round ``INGEST_PUSH_ROUND`` the
#: project is put and one revision of it pushed (over HTTP on (a) with the
#: API user's key, through the same ``RestApi`` handler in process on (b));
#: the agent pass after that round also runs the generator; before round
#: ``INGEST_MORE_ROUND`` a revision source holding one new commit is
#: registered (the ``repotracker`` job polls it), a patch narrowed to
#: ``INGEST_PATCH_VARIANTS`` variants and two selectors is posted with
#: ``finalize``, and a merge group of ``INGEST_MERGE_VARIANTS`` variants is
#: enqueued (``enqueue_merge_group``, the call the webhook makes). The job
#: order puts ``scheduler-tick`` before ``generate-tasks``, ``activation``
#: and ``repotracker`` in a round, so round 4 ticks what round 3 made
INGEST_PROJECT_ID = "monorepo"
INGEST_TASK_DEFS = 50
INGEST_BATCHTIME = 10
INGEST_GEN_VARIANTS = 3
INGEST_PATCH_VARIANTS = 3
INGEST_MERGE_VARIANTS = 4
INGEST_PUSH_ROUND = 2
INGEST_MORE_ROUND = 3
#: the API user the seeded directory holds (superuser: it puts projects)
INGEST_USER = ("smoke-admin", "smoke-admin-api-key")
#: the clock of each cron round after ``NOW``: round 3 comes a minute after
#: the push, when the batchtime variants' window (1 minute) has passed
CRON_ROUND_AT = (0.0, TICK_STEP_S, TICK_STEP_S + 60.0, 2 * TICK_STEP_S + 60.0)


def shell(script) -> dict:
    return {"command": "shell.exec", "params": {"script": script}}


def ingest_project(distro_ids, seed=SEED, identifier="", generator=True,
                   matrix=False) -> str:
    """The project's text (JSON, which is YAML) for ``distro_ids``: a
    variant ``vNNN`` on each, the ``INGEST_TASK_DEFS`` definitions
    (``compile``; ``unit-NN`` after it, tagged ``test``; ``lint-NN``,
    tagged ``lint``; ``integ-NN`` after ``unit-00`` in the task group
    ``integration`` with ``max_hosts: 2``; the chain ``chain-0`` … ``chain-8``
    after ``compile``; ``package`` after the chain's end), listed through
    names, the selectors ``.test``, ``.lint``, ``.chain`` and the group;
    each variant's display task ``lint-all``; ``batchtime: 1`` on
    ``INGEST_BATCHTIME`` variants drawn from ``seed``; the generator
    (priority 100) in variant ``v001``; with ``matrix``, a 2 × 2 matrix
    on the first two distros."""
    import random

    rng = random.Random(seed)
    lints = [f"lint-{i:02d}" for i in range(10)]
    tasks = [{"name": "compile", "tags": ["build"],
              "commands": [shell("echo compile ${build_variant}")]}]
    tasks += [{"name": f"unit-{i:02d}", "tags": ["test"], "depends_on": ["compile"],
               "priority": rng.randrange(50), "commands": [shell(f"echo unit {i}")]}
              for i in range(19)]
    tasks += [{"name": n, "tags": ["lint"], "commands": [shell(f"echo {n}")]} for n in lints]
    tasks += [{"name": f"integ-{i:02d}", "depends_on": [{"name": "unit-00"}],
               "commands": [shell(f"echo integ {i}")]} for i in range(10)]
    tasks += [{"name": f"chain-{i}", "tags": ["chain"],
               "depends_on": ["compile" if i == 0 else f"chain-{i - 1}"],
               "commands": [shell(f"echo chain {i}")]} for i in range(9)]
    tasks += [{"name": "package", "depends_on": [{"name": "chain-8"}, {"name": "lint-00"}],
               "commands": [shell("echo package")]}]
    assert len(tasks) == INGEST_TASK_DEFS
    payload = {
        "tasks": [{"name": "gen-a", "depends_on": [{"name": "compile"}],
                   "commands": [shell("echo generated a")]},
                  {"name": "gen-b", "commands": [shell("echo generated b")]}],
        "buildvariants": [{"name": f"v{i:03d}", "tasks": ["gen-a", "gen-b"]}
                          for i in range(INGEST_GEN_VARIANTS)],
    }
    if generator:
        tasks.append({"name": "generate-extra", "priority": 100, "commands": [
            shell(f"printf '%s' '{json.dumps(payload)}' > gen.json"),
            {"command": "generate.tasks", "params": {"files": ["gen.json"]}}]})
    # the batchtime variants: not the generator's, the matrix's distros',
    # the patch's or the merge group's
    rest = range(2 + INGEST_PATCH_VARIANTS + INGEST_MERGE_VARIANTS, len(distro_ids))
    batch = set(rng.sample(rest, min(INGEST_BATCHTIME, len(rest) // 2)))
    variants = []
    for i, d in enumerate(distro_ids):
        units = [{"name": "compile"}, {"name": ".test"}, {"name": ".lint"},
                 {"name": "integration"}, {"name": ".chain"}, {"name": "package"}]
        if generator and i == 1:
            units.append({"name": "generate-extra"})
        bv = {"name": f"v{i:03d}", "display_name": f"variant {i} on {d}", "run_on": [d],
              "expansions": {"shard": str(i)}, "tasks": units,
              "display_tasks": [{"name": "lint-all", "execution_tasks": lints}]}
        if i in batch:
            bv["batchtime"] = 1
        variants.append(bv)
    doc = {"identifier": identifier or INGEST_PROJECT_ID, "branch": "main",
           "exec_timeout_secs": 600, "tasks": tasks,
           "task_groups": [{"name": "integration", "max_hosts": 2,
                            "tasks": [f"integ-{i:02d}" for i in range(10)],
                            "setup_group": [shell("echo setup")]}],
           "buildvariants": variants}
    if matrix:
        doc["axes"] = [
            {"id": "os", "values": [{"id": "linux", "run_on": [distro_ids[0]]},
                                    {"id": "bsd", "run_on": [distro_ids[1]]}]},
            {"id": "py", "values": [{"id": "py311", "variables": {"python": "3.11"}},
                                    {"id": "py312", "variables": {"python": "3.12"}}]}]
        variants.append({"matrix_name": "mx", "display_name": "${os} ${py}",
                         "matrix_spec": {"os": "*", "py": "*"},
                         "tasks": [{"name": "compile"}, {"name": ".lint"}]})
    return json.dumps(doc, indent=1)


def http_json(base, method, path, body=None, headers=None) -> tuple:
    """One JSON request to ``base``; returns (status, payload)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode() if body is not None else None,
        method=method, headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def api_headers() -> dict:
    return {"Api-User": INGEST_USER[0], "Api-Key": INGEST_USER[1]}


def queue_rows(store) -> dict:
    """Task id -> (distro, version, requester) of every row of the primary
    queue documents."""
    from evergreen_tpu_torch.models.task_queue import doc_column

    out = {}
    for doc in store.collection("task_queues").find():
        for row in zip(doc_column(doc, "id"), doc_column(doc, "version"),
                       doc_column(doc, "requester")):
            out[row[0]] = (doc["distro_id"], *row[1:])
    return out


def ingest_push(envs, base, enter, leave, now, distro_ids, project_mod) -> dict:
    """Before round ``INGEST_PUSH_ROUND``: ``PUT`` the project and ``POST``
    one revision of ``ingest_project`` to each environment (over HTTP on
    (a) with the API user's key, through the same ``RestApi`` handler in
    process on (b)), the answers equal; prints each push's ms and the
    10,000-task version's parse and materialize ms apart. Returns what
    the later steps read."""
    text = ingest_project(distro_ids)
    rev = "a1" * 20
    ref = {"enabled": True, "owner": "smoke", "repo": INGEST_PROJECT_ID, "branch": "main"}
    body = {"revision": rev, "author": "smoke", "message": "the pushed revision",
            "config_yaml": text}
    calls = (("PUT", f"/rest/v2/projects/{INGEST_PROJECT_ID}", ref),
             ("POST", f"/rest/v2/projects/{INGEST_PROJECT_ID}/revisions", body))
    real = (project_mod.parse_project, project_mod.materialize_version)
    out = {}
    for key, env in envs.items():
        split = {}

        def timed(fn, name, split=split):
            def run(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    split[name] = (time.perf_counter() - t0) * 1e3
            return run

        answers, ms = [], []
        enter(key, now)
        project_mod.parse_project = timed(real[0], "parse")
        project_mod.materialize_version = timed(real[1], "materialize")
        try:
            for method, path, b in calls:
                t0 = time.perf_counter()
                if key == "a":
                    answers.append(http_json(base, method, path, b, api_headers()))
                else:
                    answers.append(tuple(env.api.handle(method, path, dict(b))))
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            project_mod.parse_project, project_mod.materialize_version = real
            leave()
        out[key] = (answers, ms, split)
    check(out["a"][0] == out["b"][0], f"ingest: the push's answers differ: "
          f"{str(out['a'][0])[:300]} against {str(out['b'][0])[:300]}")
    (st_ref, _), (st_rev, made) = out["a"][0]
    want = len(distro_ids) * INGEST_TASK_DEFS + 1
    check((st_ref, st_rev) == (200, 201) and made.get("n_tasks") == want,
          f"ingest: the push answered {st_ref}, {st_rev} {made}; expected {want} tasks")
    log(f"ingest: PUT /rest/v2/projects/{INGEST_PROJECT_ID} and POST .../revisions "
        f"({len(text)} bytes of project, {len(distro_ids)} variants): "
        f"version {made['version_id']} with {want} tasks in (a) and (b); ms (a) over "
        f"HTTP {out['a'][1][0]:.1f} + {out['a'][1][1]:.1f}, (b) in process "
        f"{out['b'][1][0]:.1f} + {out['b'][1][1]:.1f}; of the revision's, parse "
        f"{out['a'][2]['parse']:.1f} / {out['b'][2]['parse']:.1f} and materialize "
        f"{out['a'][2]['materialize']:.1f} / {out['b'][2]['materialize']:.1f} ms (a) / (b)")
    READINGS["ingest push ms"] = out["a"][1][1]
    return {"text": text, "rev": rev, "version": made["version_id"], "n_tasks": want}


def ingest_generator(envs, enter, leave, now, task_mod, host_mod, lifecycle) -> tuple:
    """Before the agent pass after round ``INGEST_PUSH_ROUND``: the pushed
    version's generator, which round 2's tick queued behind config 3's
    backlog (weeks older, it ranks ahead), is dispatched to the first free
    host of its distro in each environment, as the seed dispatches its
    tasks in flight (``mark_task_dispatched``, ``assign_running_task``).
    The pass then runs it with the others in flight: its shell command
    writes the payload, ``generate.tasks`` stages it, the end posts it.
    Returns (the generator, its host)."""
    a = envs["a"]
    gen = [t for t in task_mod.find(a.store, lambda d: d["display_name"] == "generate-extra")]
    check(len(gen) == 1 and gen[0].status == "undispatched" and gen[0].activated,
          f"agent pass: generators {[(t.id, t.status, t.activated) for t in gen]}")
    gen = gen[0]
    free = sorted(h.id for h in host_mod.find(a.store, lambda d: d["distro_id"] == gen.distro_id)
                  if h.can_run_tasks() and not h.running_task)
    check(free, f"agent pass: no free host of {gen.distro_id} for the generator")
    for key, env in envs.items():
        enter(key, now)
        try:
            t = task_mod.get(env.store, gen.id)
            check(lifecycle.mark_task_dispatched(env.store, t.id, free[0], now=now)
                  and host_mod.assign_running_task(env.store, free[0], t, now),
                  f"agent pass ({key}): the generator not dispatched to {free[0]}")
        finally:
            leave()
    return gen.id, free[0]


def ingest_generated(envs, gen, finished) -> None:
    """After the agent pass: the generator ended ``success`` and its
    payload is staged for the ``generate-tasks`` job in each environment."""
    tid, hid = gen
    check(dict(finished).get(tid) == "success",
          f"agent pass: the generator {tid} ended {dict(finished).get(tid)!r}")
    for key, env in envs.items():
        req = env.store.collection("generate_requests").get(tid)
        check(req is not None and not req["processed"] and req["payloads"],
              f"agent pass ({key}): the generator's request {req}")
    log(f"ingest: the agent pass ran the generator {tid} on {hid} in (a), over HTTP, "
        f"and (b): success, its generate.tasks payload staged")


def ingest_more(envs, base, enter, leave, now, distro_ids, ingest, repotracker,
                merge_queue) -> dict:
    """Before round ``INGEST_MORE_ROUND``: a revision source holding one new
    commit registered for the project (the ``repotracker`` job of each
    environment polls it); a patch of ``INGEST_PATCH_VARIANTS`` variants and
    the selectors ``compile`` and ``.lint`` posted with ``finalize`` (over
    HTTP on (a)); a merge group of ``INGEST_MERGE_VARIANTS`` variants on the
    next distros enqueued. The answers equal."""
    class Commits(repotracker.RevisionSource):
        """The branch's commits, newest first."""

        def __init__(self, revs):
            self.revs = revs

        def get_recent_revisions(self, n):
            return self.revs[:n]

        def get_revisions_after(self, revision, max_revs):
            shas = [r.revision for r in self.revs[:max_revs]]
            if revision not in shas:
                raise KeyError(f"revision {revision!r} not found")
            return self.revs[:shas.index(revision)]

    polled = "b2" * 20
    text2 = ingest_project(distro_ids, identifier=f"{INGEST_PROJECT_ID}-2", matrix=True)
    repotracker.register_revision_source(INGEST_PROJECT_ID, Commits([
        repotracker.Revision(revision=polled, author="smoke", message="the polled commit",
                             config_yaml=text2),
        repotracker.Revision(revision=ingest["rev"], author="smoke",
                             message="the pushed revision", config_yaml=ingest["text"])]))
    first = 2
    patch_ids = distro_ids[first:first + INGEST_PATCH_VARIANTS]
    merge_ids = distro_ids[first + INGEST_PATCH_VARIANTS:
                           first + INGEST_PATCH_VARIANTS + INGEST_MERGE_VARIANTS]
    # the patch is based on the new commit: its task ids carry the base
    # revision and the patch number, which on the pushed revision would be
    # the pushed version's (order 1), as in the JAX package
    patch = {"id": "smoke-patch", "project": INGEST_PROJECT_ID, "author": "smoke",
             "description": "a narrowed patch", "githash": polled,
             "variants": [f"v{i:03d}" for i in range(first, first + INGEST_PATCH_VARIANTS)],
             "tasks": ["compile", ".lint"], "config_yaml": text2, "finalize": True}
    merge_text = ingest_project(merge_ids, identifier=f"{INGEST_PROJECT_ID}-merge",
                                generator=False)
    merge_sha = "c3" * 20
    out = {}
    for key, env in envs.items():
        enter(key, now)
        try:
            t0 = time.perf_counter()
            if key == "a":
                got = http_json(base, "POST", "/rest/v2/patches", patch, api_headers())
            else:
                got = tuple(env.api.handle("POST", "/rest/v2/patches", dict(patch)))
            t1 = time.perf_counter()
            mg = merge_queue.enqueue_merge_group(env.store, INGEST_PROJECT_ID, merge_sha,
                                                 "gh-readonly-queue/main/pr-1", merge_text)
            t2 = time.perf_counter()
        finally:
            leave()
        out[key] = (got, mg, (t1 - t0) * 1e3, (t2 - t1) * 1e3)
    check(out["a"][:2] == out["b"][:2], f"ingest: the patch or the merge group differ: "
          f"{str(out['a'][:2])[:300]} against {str(out['b'][:2])[:300]}")
    (st, pdoc), mg = out["a"][:2]
    check(st == 201 and pdoc["status"] == "started" and pdoc["version"]
          and mg == f"mg-{INGEST_PROJECT_ID}-{merge_sha[:10]}",
          f"ingest: the patch answered {st} {str(pdoc)[:300]}, the merge group {mg!r}")
    log(f"ingest: a revision source with one new commit registered; patch "
        f"{pdoc['_id']} ({len(patch_ids)} variants x compile and .lint) finalized into "
        f"{pdoc['version']}; merge group {mg} on {merge_ids}; ms (a) / (b): the patch "
        f"{out['a'][2]:.1f} over HTTP / {out['b'][2]:.1f} in process, the merge group "
        f"{out['a'][3]:.1f} / {out['b'][3]:.1f}")
    return {"polled": polled, "patch_version": pdoc["version"], "patch_distros": patch_ids,
            "merge_patch": mg, "merge_distros": merge_ids,
            "n_patch": len(patch_ids) * 11, "n_polled": ingest["n_tasks"] + 4 * 11}


def ingest_checks(envs, r, ingest, runs, distro_ids, task_queue) -> None:
    """After cron round ``r`` (from ``INGEST_PUSH_ROUND`` on), on (a), whose
    documents equal (b)'s: every activated undispatched task of the pushed
    version in its distro's queue document (the tick planned it on the
    card); after round ``INGEST_MORE_ROUND`` the patch's tasks queued in its
    distros' queues and no other (the snapshot's ``t_is_patch`` rows), the
    merge counts ``fused_distro_stats`` wrote for the merge group's distros
    non-zero and equal to (b)'s, the ``generate-tasks`` job's tasks made,
    the polled commit's version made by the ``repotracker`` job, the
    batchtime builds activated by ``activation-catchup``; after the last
    round the generated tasks, the polled version's and the batchtime
    builds' activated tasks queued. Prints the ingestion jobs' run ms."""
    a, b = envs["a"], envs["b"]
    rows = queue_rows(a.store)
    tasks = a.store.collection("tasks")

    live = {d["_id"] for d in a.store.collection("distros").find()}

    def waiting(pred):
        """Ids of the activated undispatched tasks ``pred`` takes on a
        distro that exists (the admin round deletes one: its tasks are
        planned by no tick, ``admin_checks``), and those of them not
        queued."""
        ids = sorted(d["_id"] for d in tasks.find(
            lambda d: pred(d) and d["activated"] and d["status"] == "undispatched"
            and d["distro_id"] in live))
        return ids, [t for t in ids if t not in rows]

    # the batchtime builds and the generated tasks activated after round 3's
    # tick wait for the next
    batch = {d["build_id"] for d in a.store.collection("pending_activations").find()
             if d["build_id"].startswith(ingest["version"])}
    late = r == INGEST_MORE_ROUND
    pushed, missing = waiting(lambda d: d["version"] == ingest["version"] and not (
        late and (d["build_id"] in batch or d["generated_by"])))
    check(pushed and not missing, f"round {r}: {len(missing)} of the pushed version's "
          f"{len(pushed)} waiting tasks are not queued: {missing[:3]}")
    parts = [f"pushed version {len(pushed)}"]
    if r >= INGEST_MORE_ROUND:
        prow = {t: d for t, (d, v, req) in rows.items()
                if v == ingest["patch_version"] and req == "patch_request"}
        check(sorted(set(prow.values())) == sorted(ingest["patch_distros"])
              and len(prow) == ingest["n_patch"],
              f"round {r}: patch rows {len(prow)} in {sorted(set(prow.values()))}")
        merge = {d: [task_queue.load(e.store, d).info.count_dep_filled_merge_queue
                     for e in (a, b)] for d in ingest["merge_distros"]}
        check(all(x > 0 and x == y for x, y in merge.values()),
              f"round {r}: the merge counts (a), (b) {merge}")
        req = a.store.collection("generate_requests").find()
        check(all(d["processed"] and not d.get("error") for d in req),
              f"round {r}: generate requests {[(d['_id'], d.get('error')) for d in req]}")
        gen = sorted(d["_id"] for d in tasks.find(lambda d: d["generated_by"]))
        check(len(gen) == 2 * INGEST_GEN_VARIANTS, f"round {r}: generated tasks {gen}")
        polled = [d for d in a.store.collection("versions").find()
                  if d["revision"] == ingest["polled"] and d["requester"] == "gitter_request"]
        check(len(polled) == 1 and len(tasks.find(
            lambda d: d["version"] == polled[0]["_id"])) == ingest["n_polled"],
              f"round {r}: the polled version {[d['_id'] for d in polled]}")
        pending = a.store.collection("pending_activations").find()
        check(batch and all(d["done"] for d in pending if d["build_id"] in batch),
              f"round {r}: batchtime builds {[(d['build_id'], d['done']) for d in pending]}")
        parts += [f"patch {len(prow)} in {len(ingest['patch_distros'])} distros",
                  "merge counts " + ", ".join(f"{d} {x}" for d, (x, _) in merge.items())]
        if r == INGEST_MORE_ROUND:
            parts += [f"generated {len(gen)} (not queued before the next tick)",
                      f"polled version {polled[0]['_id']} made, "
                      f"{len(batch)} batchtime builds activated"]
        else:
            gen_w, gen_m = waiting(lambda d: d["generated_by"] != "")
            poll_w, poll_m = waiting(lambda d: d["version"] == polled[0]["_id"])
            batch_w, batch_m = waiting(lambda d: d["build_id"] in batch)
            check(len(gen_w) == len(gen) and not gen_m and poll_w and not poll_m
                  and batch_w and not batch_m,
                  f"round {r}: not queued: generated {gen_m[:3]}, polled {poll_m[:3]}, "
                  f"batchtime {batch_m[:3]}")
            parts += [f"generated {len(gen_w)}", f"polled version {len(poll_w)}",
                      f"batchtime builds {len(batch_w)}"]
    log(f"ingest round {r}: queued on the card's tick (a) = (b): " + "; ".join(parts)
        + "; ingestion job run ms (a) / (b): " + ("; ".join(
            f"{jt} {runs['a'][jt]:.1f} / {runs['b'].get(jt, 0.0):.1f}"
            for jt in ("repotracker", "activation-catchup", "generate-tasks",
                       "periodic-builds") if jt in runs["a"]) or "none ran"))


def cron_docs(store, name) -> list:
    """The documents of collection ``name`` of ``store`` in store order,
    ``CRON_MASKS`` masked (spans as ``span_json`` masks them)."""
    if name == "spans":
        return [canon_span(d) for d in store.collection(name).find()
                if d["name"] != "arena_lease"]
    drop = CRON_MASKS.get(name, ())
    found = store.collection(name).find()
    return [{k: v for k, v in d.items() if k not in drop} for d in found] if drop else found


def same_cron_docs(a, b, label) -> int:
    """Every collection of stores ``a`` and ``b`` equal (``cron_docs``);
    the message names the first document that differs. Returns the
    count of documents."""
    names = sorted(set(doc_names(a)) | set(doc_names(b)) | {"spans"})
    n = 0
    for name in names:
        got, want = cron_docs(a, name), cron_docs(b, name)
        if got != want:
            k = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                     min(len(got), len(want)))
            x = got[k] if k < len(got) else None
            y = want[k] if k < len(want) else None
            keys = sorted(f for f in set(x or {}) | set(y or {})
                          if (x or {}).get(f) != (y or {}).get(f))
            check(False, f"{label}: {name} differ ({len(got)} and {len(want)} documents); "
                  f"the first at {k}, {(x or y or {}).get('_id')!r}, in {keys}: "
                  f"{json.dumps({f: (x or {}).get(f) for f in keys}, default=str)[:400]} "
                  f"against {json.dumps({f: (y or {}).get(f) for f in keys}, default=str)[:400]}")
        n += len(got)
    return n


def seed_cron_dir(problem, data_dir) -> tuple:
    """Config 3 with phase 6's capacity settings in a durable directory
    at epoch 0 (no lease), in one group frame, then checkpointed; every
    running host has a mock instance (``external_id``) in the cloud table
    the phase installs, and the overload ladder reads only the signals
    two environments can agree on (``CRON_OVERLOAD``). The version with
    the most tasks in the first distro gets ``CRON_PROJECT`` as its parser
    project, its tasks named for it, and up to ``CRON_IN_FLIGHT`` of them
    are dispatched to free hosts of their distro (``mark_task_dispatched``
    and ``assign_running_task`` at ``NOW``): the tasks in flight when the
    agent pass comes. The API user ``INGEST_USER`` is a superuser. Returns (the running hosts' ids, that version, the
    (host, task) pairs in flight)."""
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    import dataclasses

    from evergreen_tpu_torch.models.lifecycle import mark_task_dispatched
    from evergreen_tpu_torch.models.user import SCOPE_SUPERUSER, User
    from evergreen_tpu_torch.settings import OverloadConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils.benchgen import NOW

    src = Store()
    seed_tick_store(src, problem)
    OverloadConfig(**CRON_OVERLOAD).set(src)
    user = dataclasses.asdict(User(id=INGEST_USER[0], api_key=INGEST_USER[1],
                                   roles=[SCOPE_SUPERUSER]))
    user["_id"] = user.pop("id")
    src.collection("users").insert(user)
    hosts = src.collection("hosts")
    up = [d["_id"] for d in hosts.find() if d["status"] == "running"]
    for hid in up:
        hosts.update(hid, {"external_id": f"mock-{hid}"})
    tasks = src.collection("tasks")
    first = problem[0][0].id
    counts = {}
    for d in tasks.find(lambda d: d["distro_id"] == first):
        counts[d["version"]] = counts.get(d["version"], 0) + 1
    version = min(counts, key=lambda v: (-counts[v], v))
    ids = sorted(d["_id"] for d in tasks.find(lambda d: d["version"] == version))
    for i, tid in enumerate(ids):
        tasks.update(tid, {"display_name": "boom" if i % CRON_BOOM_EVERY == 1 else "echo"})
    src.collection("parser_projects").insert(dict(json.loads(json.dumps(CRON_PROJECT)),
                                                 _id=version))
    src.collection("project_vars").insert(dict(json.loads(json.dumps(ADMIN_VARS)),
                                               _id=INGEST_PROJECT_ID))
    free = sorted(d["_id"] for d in hosts.find(
        lambda d: d["distro_id"] == first and d["status"] == "running"
        and not d["running_task"]))
    runnable = [tid for tid in ids if tasks.get(tid)["status"] == "undispatched"
                and tasks.get(tid)["activated"]]
    in_flight = []
    for hid, tid in zip(free, runnable[:CRON_IN_FLIGHT]):
        check(mark_task_dispatched(src, tid, hid, now=NOW - 5.0)
              and host_mod.assign_running_task(src, hid, task_mod.get(src, tid), NOW - 5.0),
              f"cron seed: {tid} not dispatched to {hid}")
        in_flight.append((hid, tid))
    dst = DurableStore(data_dir)
    dst.begin_tick()
    for n in sorted(src._collections):
        dst.collection(n).insert_many(src.collection(n).find())
    dst.end_tick()
    dst.close()
    return up, version, in_flight


def route_class(path) -> str:
    return next((name for name, part in ROUTE_CLASSES if part in path), "other")


def timed_routes(api) -> dict:
    """Wrap ``api.handle`` to record each request's ms (routing and
    handler, what ``api_request_duration_ms`` times) by route class."""
    import threading

    lock = threading.Lock()
    by_class = {}
    real = api.handle

    def handle(method, path, body=None, headers=None):
        t0 = time.perf_counter()
        try:
            return real(method, path, body, headers)
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                by_class.setdefault(route_class(path), []).append(ms)

    api.handle = handle
    return by_class


def route_stats(by_class, start=None) -> str:
    """p50 / p99 ms and the count of each route class, from ``start``
    (class -> count already seen) on."""
    out = []
    for name in sorted(by_class):
        ms = sorted(by_class[name][(start or {}).get(name, 0):])
        if ms:
            out.append(f"{name} {ms[len(ms) // 2]:.2f} / {ms[min(len(ms) - 1, int(0.99 * len(ms)))]:.2f}"
                       f" ms ({len(ms)})")
    return "; ".join(out)


def run_agent_task(comm, task, host_id, work_dir) -> str:
    """What the agent on ``host_id`` does with ``task``, its task in
    flight, as ``Agent.run_once`` does after a pull: fetch its config,
    start it, run its blocks when it has any (``Agent._run_task``: the
    heartbeat before each command, the logs posted), end it with the
    outcome. Returns the status."""
    from evergreen_tpu_torch.agent.agent import Agent, AgentOptions

    cfg = comm.get_task_config(task, host_id)
    comm.start_task(task.id)
    outcome, artifacts = ("success", "", "", False), {}
    if cfg.commands or cfg.pre or cfg.post:
        agent = Agent(comm, AgentOptions(host_id=host_id, work_dir=work_dir))
        *outcome, artifacts = agent._run_task(cfg)
    status, details_type, details_desc, timed_out = outcome
    comm.end_task(task.id, status, details_type=details_type, details_desc=details_desc,
                  timed_out=timed_out, artifacts=artifacts)
    return status


def comm_pass(store, comm_for, work_dir) -> tuple:
    """The agent pass through communicators (``comm_for(host)``): every
    task in flight, in id order, through ``run_agent_task``; then a pull
    (``next_task``) for each of the first ``PASS_PULLS`` free hosts in id
    order. Returns (the
    finished (task, status) pairs, the (host, task) pairs, the finishing's
    wall ms, the pulls' wall ms)."""
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod

    tasks = store.collection("tasks")
    in_flight = sorted((d["_id"], d["host_id"]) for d in tasks.find(
        lambda d: d["status"] in ("dispatched", "started")))
    t0 = time.perf_counter()
    finished = [(tid, run_agent_task(comm_for(hid), task_mod.get(store, tid), hid, work_dir))
                for tid, hid in in_flight]
    finish_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hosts = sorted((h for h in host_mod.find(store)
                    if h.can_run_tasks() and not h.running_task),
                   key=lambda h: h.id)[:PASS_PULLS]
    pairs = []
    for h in hosts:
        t = comm_for(h.id).next_task(h.id)
        pairs.append((h.id, t.id if t is not None else None))
    return finished, pairs, finish_ms, (time.perf_counter() - t0) * 1e3


#: the distros whose queue route phase 12 reads after each round
READ_DISTROS = 4


def read_paths(store, distro_ids, version) -> list:
    """(path, query) of a GET of every route of ``api/readcache.py::
    _ROUTES`` on a phase 12 store: ``READ_DISTROS`` distros' queues, the
    first running host, the seeded version with its tasks, its first
    task, the ingested project's first build with its display tasks and
    the project's last green version of that build's variant."""
    from evergreen_tpu_torch.api import readcache

    hosts = store.collection("hosts")
    host = min(d["_id"] for d in hosts.find(lambda d: d["status"] == "running"))
    task = min(d["_id"] for d in store.collection("tasks").find(
        lambda d: d["version"] == version))
    builds = sorted((d["_id"], d["build_variant"]) for d in store.collection("builds").find(
        lambda d: d.get("project") == INGEST_PROJECT_ID))
    build, variant = builds[0] if builds else ("none", "none")
    paths = [("/rest/v2/status", {})]
    paths += [(f"/rest/v2/distros/{d}/queue", {}) for d in distro_ids[:READ_DISTROS]]
    paths += [("/rest/v2/hosts", {}), (f"/rest/v2/hosts/{host}", {}),
              ("/rest/v2/distros", {}), (f"/rest/v2/distros/{distro_ids[0]}", {}),
              ("/rest/v2/versions", {}), (f"/rest/v2/versions/{version}", {}),
              (f"/rest/v2/versions/{version}/tasks", {}), (f"/rest/v2/tasks/{task}", {}),
              (f"/rest/v2/builds/{build}", {}), (f"/rest/v2/builds/{build}/display_tasks", {}),
              ("/rest/v2/projects", {}), ("/rest/v2/patches", {}),
              (f"/rest/v2/projects/{INGEST_PROJECT_ID}/last_green", {"variants": variant})]
    check(sorted({readcache.route_for(p_)[0] for p_, _ in paths})
          == sorted(name for name, _, _ in readcache._ROUTES),
          "phase 12's reads miss a route of readcache._ROUTES")
    return paths


def etag_parts(etag):
    """An ETag without its store tag: (the serving store's kind, ``W/"p``
    for a primary or ``W/"r`` for a replica, and the change tokens)."""
    kind, _, rest = (etag or "").split("-", 2) if etag else ("", "", "")
    return kind, rest


def catch_up(envs, label) -> dict:
    """Each environment's WAL flushed (``sync_persist``) and its follower
    (the ``ReplicaStore`` ``Environment.build`` attached to its API)
    polled until a poll applies nothing: at the WAL's end, its
    ``applied_seq`` the store's ``wal_seq``, serving. Returns each one's
    (records applied, ms)."""
    out = {}
    for key, env in envs.items():
        follower = env.api.read_replica
        t0 = time.perf_counter()
        env.store.sync_persist()
        n = 0
        while True:
            got = follower.poll()
            n += got
            if not got:
                break
        out[key] = (n, (time.perf_counter() - t0) * 1e3)
        check(follower.applied_seq == env.store.wal_seq and follower.serve_ready(),
              f"{label} ({key}): the follower at seq {follower.applied_seq}, the WAL at "
              f"{env.store.wal_seq}, serving {follower.serve_ready()}")
    return out


def read_round(envs, enter, leave, now, paths, seen, fused, label) -> dict:
    """Every path of ``read_paths`` through each environment's
    ``RestApi.handle`` in process, with the API user's key, inside the
    round's pinned clock, after ``catch_up``: first a conditional GET with
    the ETag the previous round's read of that path got (none before its
    first 200), then, after a 200, a plain GET that the response cache
    answers. Holds, in each environment: a queue route answers 304
    exactly when the persister's fingerprint version and the queue
    document's stamps (``generated_at``, ``dirty_at``) did not move since
    that read and the same store served both (a follower's ETag carries
    its id, the primary's its own tag), and a 200 carries a new ETag and
    equals the queue document as the tick wrote it (``task_queue.load``,
    through JSON: the follower's rows come from the WAL's JSON);
    ``api_cache_hits_total`` rises by the 304s and the cache hits,
    ``api_cache_misses_total`` by the first 200s; nothing launches.
    Across (a) and (b): the same statuses, payloads, serving kinds and
    ETags with the store tag masked. ``seen[key][path]`` keeps (ETag,
    queue state, the serving follower's id or None). Returns the
    statuses, each environment's read ms, and the share of reads its
    follower served with the staleness it reported at each."""
    from evergreen_tpu_torch.api import readcache
    from evergreen_tpu_torch.models import task_queue
    from evergreen_tpu_torch.models.task_queue import doc_column
    from evergreen_tpu_torch.scheduler.persister import fingerprint_version

    hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
    answers, ms, follower = {}, {}, {}
    for key, env in envs.items():
        api, store = env.api, env.store
        hits0, misses0 = readcache.API_CACHE_HITS.total(), readcache.API_CACHE_MISSES.total()
        reset_launches(*fused)
        got, n_hit, n_miss, times, stale = [], 0, 0, [], []
        enter(key, now)
        try:
            for path, query in paths:
                prev = seen[key].get(path + json.dumps(query))
                queue = path.endswith("/queue") and path.split("/")[-2]
                state = None
                if queue:
                    doc = store.collection("task_queues").get(queue)
                    state = (fingerprint_version(store, queue), doc.get("generated_at"),
                             doc.get("dirty_at")) if doc else None
                t0 = time.perf_counter()
                st, payload = api.handle("GET", path, dict(query), dict(
                    hdr, **({"if-none-match": prev[0]} if prev else {})))
                times.append(((time.perf_counter() - t0) * 1e3, path))
                headers = dict(api._ident.response_headers or [])
                etag, served = headers.get("ETag"), headers.get("X-Evg-Served-By")
                stale.append(None if served is None else int(headers["X-Evg-Staleness-Ms"]))
                if queue and prev is not None:
                    check((st == 304) == (state == prev[1] and served == prev[2]),
                          f"read {label} ({key}): {path} answered {st}; its queue state "
                          f"{prev[1]} -> {state}, served by {prev[2]} -> {served}")
                if st == 304:
                    n_hit += 1
                    check(etag == prev[0], f"read {label} ({key}): a 304 with a new ETag")
                elif st == 200:
                    n_miss += 1
                    check(etag and (prev is None or etag != prev[0]),
                          f"read {label} ({key}): {path} answered 200 with ETag {etag}")
                    if queue:
                        check(json.loads(json.dumps(payload)) == json.loads(json.dumps(
                                  task_queue.load(store, queue).to_doc()))
                              and [i["id"] for i in payload["queue"]]
                              == doc_column(doc, "id")
                              and payload["generated_at"] == doc["generated_at"],
                              f"read {label} ({key}): {path} is not the tick's document")
                    again = api.handle("GET", path, dict(query), dict(hdr))
                    check(again == (200, payload), f"read {label} ({key}): the cache hit "
                          f"of {path} differs")
                    n_hit += 1
                if etag:
                    seen[key][path + json.dumps(query)] = (etag, state, served)
                got.append((path, st, payload if st == 200 else None, etag_parts(etag)))
        finally:
            leave()
        check(read_launches(*fused) == {"fused_distro_stats": 0, "segment_sum": 0},
              f"read {label} ({key}): a read launched a kernel")
        check((readcache.API_CACHE_HITS.total() - hits0,
               readcache.API_CACHE_MISSES.total() - misses0) == (n_hit, n_miss),
              f"read {label} ({key}): the cache counters moved "
              f"{readcache.API_CACHE_HITS.total() - hits0} / "
              f"{readcache.API_CACHE_MISSES.total() - misses0}, expected {n_hit} / {n_miss}")
        answers[key], ms[key] = got, sorted(times)
        follower[key] = (sum(x is not None for x in stale) / len(stale),
                         [x for x in stale if x is not None])
    for (pa, sa, xa, ea), (_, sb, xb, eb) in zip(answers["a"], answers["b"]):
        check((sa, xa) == (sb, xb), f"read {label}: {pa} answered {sa} on (a) and {sb} on (b)")
        check(ea == eb, f"read {label}: {pa}'s ETags, the store tag masked, {ea} on (a) and "
              f"{eb} on (b)")
    return {"statuses": [st for _, st, _, _ in answers["a"]], "ms": ms,
            "follower": follower}


#: phase 12's event plane: the HMAC secret of its webhook subscription
CRON_HOOK_KEY = "smoke-webhook-key"
#: the wire headers of a sink delivery that (a) and (b) must agree on
SINK_HEADERS = ("x-evergreen-signature", "x-evergreen-notification-id", "authorization",
                "content-type")


def cron_subscriptions(sink_url, version) -> list:
    """Phase 12's subscriptions, one for each channel the transports
    serve: a signed webhook for the seeded version's tasks' outcomes, a
    Slack channel for every task failure, email and GitHub statuses for
    the ingested project's and the merge group's versions, Jira for the
    ingested project's patches."""
    from evergreen_tpu_torch.events.triggers import Subscription

    return [
        Subscription("sub-webhook", "TASK", "outcome", "webhook", f"{sink_url}/hook",
                     filters={"version": version}, subscriber_secret=CRON_HOOK_KEY),
        Subscription("sub-slack", "TASK", "failure", "slack", "#ci-failures"),
        Subscription("sub-email", "VERSION", "outcome", "email", "release@example.com",
                     filters={"project": INGEST_PROJECT_ID}),
        Subscription("sub-jira", "PATCH", "outcome", "jira", "MONO",
                     filters={"project": INGEST_PROJECT_ID}),
        Subscription("sub-github", "VERSION", "outcome", "github-status",
                     f"smoke/{INGEST_PROJECT_ID}@cafe01",
                     filters={"requester": "github_merge_request"}),
    ]


def seed_event_plane(store, sink_url, version) -> None:
    """Egress on, every HTTP channel aimed at the local sink (the email
    channel has no SMTP host: its rows stay in their outbox), and
    ``cron_subscriptions``."""
    from evergreen_tpu_torch.events.triggers import add_subscription
    from evergreen_tpu_torch.settings import JiraConfig, NotifyConfig, SlackConfig

    NotifyConfig(egress_enabled=True, github_api_url=sink_url,
                 github_status_token="smoke-github-token").set(store)
    SlackConfig(api_url=f"{sink_url}/slack", token="smoke-slack-token").set(store)
    JiraConfig(host=sink_url).set(store)
    for sub in cron_subscriptions(sink_url, version):
        add_subscription(store, sub)


def sink_deliveries(posts, label) -> list:
    """The sink's POSTs as (path, the ``SINK_HEADERS``, body); every
    webhook delivery's ``X-Evergreen-Signature`` is the HMAC-SHA256 of
    its body under the subscription's secret."""
    from evergreen_tpu_torch.events.transports import calculate_hmac

    out = []
    for path, headers, body in posts:
        if path == "/hook":
            check(headers.get("x-evergreen-signature")
                  == calculate_hmac(CRON_HOOK_KEY.encode(), body),
                  f"{label}: a webhook's signature is not its body's HMAC")
        out.append((path, [headers.get(h) for h in SINK_HEADERS], body.decode()))
    return out


#: the ring-only spans a tick's trace collects from other threads: the WAL
#: flusher's (one frame or two for a group commit, as its timing has it)
#: and the dispatcher's (a pull over (a)'s HTTP server joins the trace the
#: queue was planned in; (b)'s pull through ``LocalCommunicator`` on the
#: caller's thread does not): dropped from what the card and the CPU are
#: held to
RING_SPANS = ("wal.flush", "dispatch_assign")


def _flat_spans(shape) -> list:
    """Every span of a ``tree_shape``, as its masked JSON."""
    out = []
    for node in shape:
        out.append(node[0])
        out.extend(_flat_spans(node[1]))
    return out


def prune_shape(shape, drop=RING_SPANS) -> list:
    """A ``tree_shape`` without the spans named in ``drop`` (and their
    children)."""
    def walk(node):
        return [node[0], sorted((walk(c) for c in node[1]
                                 if json.loads(c[0])["name"] not in drop), key=json.dumps)]

    return sorted((walk(r) for r in shape if json.loads(r[0])["name"] not in drop),
                  key=json.dumps)


def operator_round(envs, enter, leave, now, distro_ids, fused, label) -> dict:
    """After each round, the operator's routes through each environment's
    ``RestApi.handle`` in process, with the API user's key, inside the
    round's pinned clock: ``READ_DISTROS`` distros' solve provenance and
    capacity decisions, the first one's first planned task explained,
    the fleet capacity view, the trace summaries, the ladder, the stats,
    spans, log lines and events, ``admin/fleet`` (404: no supervisor),
    the probes, and ``/metrics`` before and after. Holds, across (a) and
    (b): the statuses, the provenance and capacity documents
    (``close_route_docs``), the last tick's span tree (``tree_shape``),
    the trace summaries' roots, the ladder's level, gauges' names and
    sheds, the other documents with ``CRON_MASKS`` (the probe's
    ``follower_staleness_ms`` apart, under the serving bound); in each: the scrape
    parses, ``api_requests_total`` grew by exactly the requests between
    the two scrapes (and the first), nothing launched. Returns each
    environment's ms and the statuses."""
    from evergreen_tpu_torch.api.rest import PlainTextResponse
    from evergreen_tpu_torch.settings import ReadPathConfig

    hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
    paths = [f"/rest/v2/admin/provenance/{d}" for d in distro_ids[:READ_DISTROS]]
    paths += [f"/rest/v2/admin/capacity/{d}" for d in distro_ids[:READ_DISTROS]]
    paths += ["/rest/v2/admin/capacity", "/rest/v2/admin/traces", "/rest/v2/admin/overload",
              "/rest/v2/stats/system", "/rest/v2/stats/hosts", "/rest/v2/stats/spans",
              "/rest/v2/admin/log_lines", "/rest/v2/events", "/rest/v2/admin/fleet",
              "/healthz", "/healthz/ready"]
    query = {"/rest/v2/admin/traces": {"last": "20"}, "/rest/v2/stats/system": {"limit": "5"},
             "/rest/v2/admin/log_lines": {"limit": "50"}}
    got, ms, trees = {}, {}, {}
    for key, env in envs.items():
        api, store = env.api, env.store
        reset_launches(*fused)
        enter(key, now)
        try:
            t0 = time.perf_counter()
            st, text = api.handle("GET", "/metrics", {}, dict(hdr))
            check(st == 200 and isinstance(text, PlainTextResponse),
                  f"operator {label} ({key}): /metrics answered {st}")
            before = parse_exposition(text)
            answers = [api.handle("GET", p_, dict(query.get(p_, {})), dict(hdr))
                       for p_ in paths]
            first = answers[0][1].get("tasks") or [{"task": "none"}]
            answers.append(api.handle("GET", paths[0], {"task": first[0]["task"]}, dict(hdr)))
            st, text = api.handle("GET", "/metrics", {}, dict(hdr))
            after = parse_exposition(text)
            ms[key] = (time.perf_counter() - t0) * 1e3
            tick = [d for d in store.collection("spans").find() if d["name"] == "tick"][-1]
            trees[key] = prune_shape(tree_shape(store, tick["trace_root"] or tick["_id"],
                                                lease=False))
        finally:
            leave()
        check(read_launches(*fused) == {"fused_distro_stats": 0, "segment_sum": 0},
              f"operator {label} ({key}): a read launched a kernel")
        moved = series_sum(after, "api_requests_total") - series_sum(before, "api_requests_total")
        check(moved == len(answers) + 1, f"operator {label} ({key}): api_requests_total "
              f"moved {moved} for {len(answers) + 1} requests")
        got[key] = answers
    if trees["a"] != trees["b"]:
        flat = {k: sorted(json.dumps(json.loads(x)) for x in _flat_spans(t))
                for k, t in trees.items()}
        only = {k: [x for x in flat[k] if x not in flat["b" if k == "a" else "a"]][:3]
                for k in flat}
        check(False, f"operator {label}: the last tick's span trees differ: {only}")
    for path, (sa, xa), (sb, xb) in zip(paths + ["explain"], got["a"], got["b"]):
        check(sa == sb, f"operator {label}: {path} answered {sa} on (a) and {sb} on (b)")
        if sa != 200:
            check(xa == xb, f"operator {label}: {path}'s errors differ")
        elif "/provenance/" in path or "/capacity" in path or path == "explain":
            close_route_docs(xa, xb, f"operator {label}: {path}")
        elif path.endswith("/traces"):
            # the ring-only spans' own traces come as their threads have them
            ta, tb = ([(t["root"], t["component"]) for t in x["traces"]
                       if t["root"] not in RING_SPANS] for x in (xa, xb))
            n = min(len(ta), len(tb))
            check(n and ta[-n:] == tb[-n:], f"operator {label}: the trace summaries differ")
        elif path.endswith("/overload"):
            check((xa["level"], sorted(xa["gauges"]), xa["sheds"])
                  == (xb["level"], sorted(xb["gauges"]), xb["sheds"]),
                  f"operator {label}: the ladders differ")
        elif path.endswith("/stats/spans"):
            # the last 200 spans: the CPU's arena leases (which the card's
            # mirror does not take) shift its window
            sa, sb = ([canon_span(d) for d in x if d["name"] != "arena_lease"]
                      for x in (xa, xb))
            n = min(len(sa), len(sb))
            check(n and sa[-n:] == sb[-n:], f"operator {label}: the spans differ")
        else:
            drop = {"/rest/v2/stats/system": CRON_MASKS["system_stats"],
                    "/rest/v2/admin/log_lines": CRON_MASKS["log_lines"]}.get(path, ())
            if drop:
                xa = [{k: v for k, v in d.items() if k not in drop} for d in xa]
                xb = [{k: v for k, v in d.items() if k not in drop} for d in xb]
            if path == "/healthz/ready":
                # each primary's follower reports its own staleness
                lag = [x.pop("follower_staleness_ms", None) for x in (xa, xb)]
                check(all(x is not None and 0.0 <= x < ReadPathConfig().staleness_bound_ms
                          for x in lag), f"operator {label}: the followers' staleness {lag}")
            check(xa == xb, f"operator {label}: {path} differs")
    check(got["a"][paths.index("/rest/v2/admin/fleet")][0] == 404
          and got["a"][0][0] == 200 and got["a"][-1][0] == 200,
          f"operator {label}: statuses {[st for st, _ in got['a']]}")
    return {"ms": ms, "statuses": [st for st, _ in got["a"]]}


#: phase 12's spawn-host and volume round: before its ticks the API user
#: spawns a host on the first distro, extends it, stops and starts it,
#: makes a volume and attaches it (``SPAWN_OPEN``); after them the volume
#: is detached and deleted and the host terminated (``SPAWN_CLOSE``).
#: ``{h}`` and ``{v}`` are the host's and the volume's ids; the user is
#: named in the bodies for (b), which requires no auth
SPAWN_ROUND = INGEST_MORE_ROUND
SPAWN_OPEN = (("POST", "/rest/v2/hosts", {"distro": "{d}", "user": INGEST_USER[0]}),
              ("POST", "/rest/v2/hosts/{h}/extend_expiration", {"hours": 6}),
              ("POST", "/rest/v2/hosts/{h}/stop", {}),
              ("POST", "/rest/v2/hosts/{h}/start", {}),
              ("POST", "/rest/v2/volumes", {"size_gb": 40, "zone": "smoke-1a",
                                            "user": INGEST_USER[0]}),
              ("POST", "/rest/v2/volumes/{v}/attach", {"host": "{h}"}))
SPAWN_CLOSE = (("POST", "/rest/v2/volumes/{v}/detach", {}),
               ("DELETE", "/rest/v2/volumes/{v}", {}),
               ("POST", "/rest/v2/hosts/{h}/terminate", {}))


def spawn_sequence(envs, enter, leave, now, calls, ids, label) -> dict:
    """``calls`` through each environment's ``RestApi.handle`` with the API
    user's key, inside the round's pinned clock; ``ids`` fills in
    ``{d}``, ``{h}`` and ``{v}``, the host's and the volume's taken from
    (a)'s answers. Holds each answer 200 and (a)'s equal to (b)'s (each
    environment draws the ids from its own uuid4 stream). Returns each
    environment's ms a request."""
    hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
    got, ms = {}, {}
    for key, env in envs.items():
        got[key], ms[key] = [], []
        enter(key, now)
        try:
            for method, path, body in calls:
                fill = {k: (v.format(**ids) if isinstance(v, str) else v)
                        for k, v in body.items()}
                t0 = time.perf_counter()
                st, out = env.api.handle(method, path.format(**ids), fill, dict(hdr))
                ms[key].append((time.perf_counter() - t0) * 1e3)
                check(st == 200, f"spawn {label} ({key}): {method} {path} answered {st} {out}")
                got[key].append(json.loads(json.dumps(out)))
                if key == "a" and path == "/rest/v2/hosts":
                    ids["h"] = out["_id"]
                elif key == "a" and path == "/rest/v2/volumes":
                    ids["v"] = out["_id"]
        finally:
            leave()
    check(got["a"] == got["b"], f"spawn {label}: the answers differ")
    return ms


#: phase 12's admin round, before round ``ADMIN_ROUND``'s ticks:
#: the pushed version aborted, then restarted; a distro with queued tasks
#: drained and deleted (the last whose hosts run no task, past the
#: distros the reads, the spawn host, the generator, the patch and the
#: merge group use); the fleet intent budget cut to ``ADMIN_BUDGET`` (from
#: phase 6's ``PLAN_BUDGET``) and one task limit set; a failed task of the
#: seeded version annotated, its project's reliability read; the pushed
#: project copied (``ADMIN_COPY``) with its variables (``ADMIN_VARS``, one
#: private), seeded by ``seed_cron_dir``
ADMIN_ROUND = INGEST_MORE_ROUND
ADMIN_BUDGET = 200
ADMIN_LIMITS = {"max_task_execution": 5}
ADMIN_COPY = f"{INGEST_PROJECT_ID}-copy"
ADMIN_VARS = {"vars": {"region": "smoke-1", "deploy_token": "t0k3n"},
              "private_vars": {"deploy_token": True}}


@contextlib.contextmanager
def checking_credentials(envs):
    """Every environment's API checks credentials while the context is
    open: the admin routes and the GraphQL resolvers act as the
    authenticated user, and (b)'s API otherwise has none."""
    auth = {key: env.api.require_auth for key, env in envs.items()}
    try:
        for env in envs.values():
            env.api.require_auth = True
        yield
    finally:
        for key, env in envs.items():
            env.api.require_auth = auth[key]


def admin_sequence(envs, enter, leave, now, ingest, seeded, doomed) -> dict:
    """Phase 12's admin round before the ticks of round ``ADMIN_ROUND``,
    through each environment's ``RestApi.handle`` with the API user's
    (superuser) key inside the round's pinned clock, in the same order on
    (a) and (b), both checking credentials: ``abort`` then ``restart`` of the pushed version; the
    delete of distro ``doomed``, refused (409) while its hosts live, then
    its hosts drained (terminated in the store and in the mock cloud, as
    an operator's drain leaves them) and the delete answered; ``set_admin``
    of ``capacity`` and ``task_limits``; a failed task of the seeded
    version annotated; the pushed project copied with its variables, and
    a dry run of the variables' copy with the private one. Then, each
    follower caught up, the reads: the annotation, the seeded project's
    reliability over its ``echo`` and ``boom`` tasks, the copy's events
    and the settings. Holds each answer as expected and (a)'s equal to
    (b)'s; returns (a)'s answers and each environment's ms a request."""
    from evergreen_tpu_torch.cloud.mock import MockCloudManager

    hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
    a = envs["a"]
    tasks = a.store.collection("tasks")
    failed = sorted(d["_id"] for d in tasks.find(
        lambda d: d["version"] == seeded and d["status"] == "failed"))
    check(failed, f"admin: no failed task in the seeded version {seeded}")
    project = tasks.get(failed[0])["project"]
    busy = [d["_id"] for d in a.store.collection("hosts").find(
        lambda d: d["distro_id"] == doomed and d["running_task"])]
    check(not busy, f"admin: hosts of {doomed} run tasks: {busy}")
    refused = (
        ("POST", f"/rest/v2/versions/{ingest['version']}/abort", {}, 200),
        ("POST", f"/rest/v2/versions/{ingest['version']}/restart", {}, 200),
        ("DELETE", f"/rest/v2/distros/{doomed}", {}, 409))
    writes = (
        ("DELETE", f"/rest/v2/distros/{doomed}", {}, 200),
        ("POST", "/rest/v2/admin/settings", {
            "capacity": {"fleet_intent_budget": ADMIN_BUDGET},
            "task_limits": dict(ADMIN_LIMITS)}, 200),
        ("PUT", f"/rest/v2/tasks/{failed[0]}/annotation", {
            "note": "fails on purpose", "user": INGEST_USER[0],
            "issues": [{"url": "https://issues.example/SMOKE-1", "issue_key": "SMOKE-1"}]},
         200),
        ("POST", f"/rest/v2/projects/{INGEST_PROJECT_ID}/copy", {"new_project": ADMIN_COPY},
         200),
        ("POST", f"/rest/v2/projects/{INGEST_PROJECT_ID}/copy/variables", {
            "copy_to": ADMIN_COPY, "include_private": True, "dry_run": True}, 200))
    reads = (
        ("GET", f"/rest/v2/tasks/{failed[0]}/annotations", {}, 200),
        ("GET", f"/rest/v2/projects/{project}/task_reliability", {"tasks": "echo,boom"}, 200),
        ("GET", f"/rest/v2/projects/{ADMIN_COPY}/events", {}, 200),
        ("GET", "/rest/v2/admin/settings", {}, 200))
    got, ms = {}, {}

    def drain(env):
        hosts = env.store.collection("hosts")
        for d in hosts.find(lambda d: d["distro_id"] == doomed
                            and d["status"] != "terminated"):
            hosts.update(d["_id"], {"status": "terminated"})
            if d.get("external_id") in MockCloudManager.instances:
                MockCloudManager.instances[d["external_id"]] = "terminated"

    def send(key, env, calls):
        for method, path, body, want in calls:
            t0 = time.perf_counter()
            st, out = env.api.handle(method, path, dict(body), dict(hdr))
            ms[key].append((time.perf_counter() - t0) * 1e3)
            check(st == want, f"admin ({key}): {method} {path} answered {st}, expected "
                  f"{want}: {str(out)[:300]}")
            got[key].append(json.loads(json.dumps(out)))

    # (b)'s API checks credentials for the round too, so that both record
    # the superuser as the actor (the events of a copy name it)
    with checking_credentials(envs):
        for key, env in envs.items():
            got[key], ms[key] = [], []
            enter(key, now)
            try:
                send(key, env, refused)
                drain(env)
                send(key, env, writes)
            finally:
                leave()
        caught = catch_up(envs, "admin")
        for key, env in envs.items():
            enter(key, now)
            try:
                send(key, env, reads)
            finally:
                leave()
    diff = [k for k, (x, y) in enumerate(zip(got["a"], got["b"])) if x != y]
    check(not diff and len(got["a"]) == len(got["b"]),
          f"admin: the answers of (a) and (b) differ at {diff}: "
          f"{str([got['a'][k] for k in diff])[:400]} against "
          f"{str([got['b'][k] for k in diff])[:400]}")
    (abort, restart, refused, deleted, settings, note, copied, preview, ann, rel, events,
     admin) = got["a"]
    gen = [d["_id"] for d in tasks.find(lambda d: d["version"] == ingest["version"]
                                        and d["display_name"] == "generate-extra")]
    check(abort["deactivated"] and restart == {"restarted": gen},
          f"admin: the abort deactivated {len(abort['deactivated'])}, the restart "
          f"{restart} (the generator {gen})")
    check("live host" in refused["error"] and deleted == {"ok": True}
          and settings == {"updated": ["capacity", "task_limits"]},
          f"admin: the delete {refused} then {deleted}, the settings {settings}")
    check(ann["note"] == note["note"] == "fails on purpose"
          and [i["issue_key"] for i in ann["issues"]] == ["SMOKE-1"],
          f"admin: the annotation read back {ann}")
    finished = [d for d in tasks.find(lambda d: d["project"] == project
                                      and d["display_name"] in ("echo", "boom")
                                      and d["status"] in ("success", "failed"))]
    check(rel and sum(g["num_total"] for g in rel) == len(finished)
          and sum(g["num_failed"] for g in rel)
          == sum(1 for d in finished if d["status"] == "failed"),
          f"admin: reliability {rel} over {len(finished)} finished tasks")
    check(copied["_id"] == ADMIN_COPY and copied["enabled"] is False
          and preview == {"vars": {"region": "smoke-1", "deploy_token": ""},
                          "dry_run": True}
          and [e["event_type"] for e in events["events"]] == ["PROJECT_COPIED"]
          and admin["capacity"]["fleet_intent_budget"] == ADMIN_BUDGET
          and all(admin["task_limits"][k] == v for k, v in ADMIN_LIMITS.items()),
          f"admin: the copy {copied}, its variables' preview {preview}, its events "
          f"{events}, the settings read back")
    vars_b = envs["b"].store.collection("project_vars").get(ADMIN_COPY)
    check(a.store.collection("project_vars").get(ADMIN_COPY) == vars_b
          and vars_b["vars"] == {"region": "smoke-1"},
          f"admin: the copy's variables {vars_b}")
    return {"abort": abort, "restart": restart, "rel": rel, "ms": ms, "caught": caught}


def admin_checks(envs, r, doomed, before, records, np, added=()) -> str:
    """After round ``ADMIN_ROUND``'s ticks, whose documents in (a) and (b)
    are already held equal: the card's tick planned one distro fewer (its
    tick span's ``n_distros``, the capacity program's eligible distros), no
    queue document of ``doomed`` and no queue row of its tasks anywhere;
    the capacity targets within the new budget (the capacity provenance's
    budget and new hosts, below the round before's budget), equal in (a)
    and (b); the card plane's snapshot of the tick (``records``: its
    ``sync`` calls) canonically equal to a cold ``build_snapshot`` of the
    same gather, without ``doomed``, and its mirror equal to the host
    truth. The distros ``added`` before the ticks (the GraphQL round's
    copy) count in the tick's set. Returns a line for the log."""
    from evergreen_tpu_torch.scheduler import resident
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot

    hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
    a = envs["a"]
    plane = resident.peek_resident_plane(a.store)
    spans = [d["attributes"] for d in a.store.collection("spans").find()
             if d["name"] == "tick"]
    check(spans[-1]["n_distros"] == before["n_distros"] - 1 + len(added),
          f"round {r}: the tick planned {spans[-1]['n_distros']} distros, "
          f"{before['n_distros']} before the delete")
    doomed_tasks = {d["_id"] for d in a.store.collection("tasks").find(
        lambda d: d["distro_id"] == doomed)}
    for key, env in envs.items():
        for name in ("task_queues", "task_secondary_queues"):
            check(env.store.collection(name).get(doomed) is None,
                  f"round {r} ({key}): {name} still holds {doomed}")
        queued = doomed_tasks & set(queue_rows(env.store))
        check(not queued, f"round {r} ({key}): {len(queued)} tasks of {doomed} queued")
    fleets = {}
    for key, env in envs.items():
        st, prov = env.api.handle("GET", "/rest/v2/admin/capacity", {"limit": 0}, dict(hdr))
        check(st == 200, f"round {r} ({key}): admin/capacity answered {st}")
        fleets[key] = prov["fleet"]
    fleet = fleets["a"]
    check(fleets["a"] == fleets["b"], f"round {r}: the capacity fleets differ: {fleets}")
    check(fleet["budget"] <= ADMIN_BUDGET < before["fleet"]["budget"]
          and fleet["new_hosts"] <= ADMIN_BUDGET
          and fleet["n_distros"] == before["fleet"]["n_distros"] - 1 + len(added),
          f"round {r}: capacity fleet {fleet}, the round before's {before['fleet']}")
    mine = [(args, snap) for plane_, args, snap in records if plane_ is plane]
    check(len(mine) == 1, f"round {r}: {len(mine)} syncs of (a)'s plane")
    args, snap = mine[0]
    cold = build_snapshot(*args[:5], args[5])
    check(doomed not in snap.distro_ids and len(snap.distro_ids) == len(cold.distro_ids)
          and all(d in snap.distro_ids for d in added),
          f"round {r}: the plane's snapshot holds {len(snap.distro_ids)} distros")
    check(resident.canonicalize(snap) == resident.canonicalize(cold),
          f"round {r}: the card plane's snapshot differs from a cold build")
    if plane.device.type == "cuda":
        check(mirror_matches_truth(np, snap),
              f"round {r}: the card's mirror differs from the host truth")
    mirror = plane.device.type == "cuda"
    return (f"{doomed} gone from the tick and {list(added)} in it "
            f"({spans[-1]['n_distros']} distros planned, "
            f"{before['n_distros']} before), {doomed} gone from the queues and the plane (canonical == "
            f"a cold build{', the mirror == the host truth' if mirror else ''}; resident "
            f"{ {k: v for k, v in plane.stats().items() if not k.startswith('mirror')} }); "
            f"the capacity fleet (a) = (b): budget {fleet['budget']} (the round before "
            f"{before['fleet']['budget']}), new hosts {fleet['new_hosts']}, "
            f"{fleet['n_distros']} distros (before {before['fleet']['n_distros']})")


def read_stats(ms) -> str:
    """p50 / max of one environment's read ms, and its slowest path."""
    return (f"{ms[len(ms) // 2][0]:.2f} / {ms[-1][0]:.2f} ({ms[-1][1].split('/rest/v2/')[-1]}), "
            f"sum {sum(x for x, _ in ms):.1f}")


# ---- phase 12's GraphQL round ----------------------------------------------- #

#: the GraphQL round runs before the ticks of the admin round, after it:
#: the priority the raised tasks get (above every other, so their units
#: lead), how many are raised, how many of the aborted version's tasks
#: are scheduled again, and the banner the settings mutation sets
GQL_ROUND = ADMIN_ROUND
GQL_PRIORITY = 100_000
GQL_RAISED = 3
GQL_SCHEDULED = 3
GQL_BANNER = {"text": "the card plans this queue", "theme": "ANNOUNCEMENT"}
#: the page's documents run as this superuser on the entities the page's
#: own test seeds (``page_world``), with its fills per input type
PAGE_USER = ("admin", "page-admin-api-key")
PAGE_FILLS = {
    "SpawnHostInput": {"distroId": "x"},
    "EditSpawnHostInput": {"hostId": "sh1"},
    "UpdateSpawnHostStatusInput": {"hostId": "sh1", "action": "START"},
    "SpawnVolumeInput": {"size": 8},
    "UpdateVolumeInput": {"volumeId": "vol-free", "name": "renamed"},
    "VolumeHost": {"volumeId": "vol-att", "hostId": "sh1"},
    "CreateDistroInput": {"newDistroId": "brand-new-distro"},
    "CopyDistroInput": {"distroIdToCopy": "x", "newDistroId": "x-copy"},
    "DeleteDistroInput": {"distroId": "x-copy"},
    "SaveDistroInput": {"onSave": "NONE", "distro": {"id": "x"}},
    "SubscriptionInput": {"resourceType": "TASK", "trigger": "TASK_FAILED",
                          "subscriber": {"type": "email", "target": "a@x.com"},
                          "selectors": []},
    "PublicKeyInput": {"name": "x", "key": "ssh-ed25519 AAAAC3NzaTESTKEY admin@host"},
    "RestartAdminTasksOptions": {"startTime": 0.0, "endTime": 9e9,
                                 "includeSystemFailed": True, "includeTestFailed": False,
                                 "includeSetupFailed": False},
    "ProjectSettingsInput": {"projectRef": {"id": "x"}},
}


def page_variables(doc) -> dict:
    """Each variable of a page document filled by its type: the scalars
    with ``x`` (``1``, ``1.0``, ``True``), the inputs from
    ``PAGE_FILLS``."""
    import re

    fills = {"String": "x", "ID": "x", "Int": 1, "Float": 1.0, "Boolean": True}
    return {name: fills.get(typ, PAGE_FILLS.get(typ, {}))
            for name, typ in re.findall(r"\$(\w+)\s*:\s*\[?(\w+)", doc)}


def page_world(store) -> None:
    """One of every entity the page reads, all with id ``x``, a stopped
    spawn host ``sh1`` of ``PAGE_USER`` with three volumes, and that user
    a superuser with its key: what the page's documents act on."""
    from evergreen_tpu_torch.cloud.volumes import Volume
    from evergreen_tpu_torch.ingestion.patches import Patch
    from evergreen_tpu_torch.models import build as build_mod
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.models import user as user_mod
    from evergreen_tpu_torch.models import version as version_mod
    from evergreen_tpu_torch.models.build import Build
    from evergreen_tpu_torch.models.distro import Distro
    from evergreen_tpu_torch.models.host import Host
    from evergreen_tpu_torch.models.task import Task
    from evergreen_tpu_torch.models.user import User
    from evergreen_tpu_torch.models.version import Version

    distro_mod.insert(store, Distro(id="x"))
    version_mod.insert(store, Version(id="x", project="x", requester="gitter_request",
                                      revision="abc123", message="seed"))
    build_mod.insert(store, Build(id="x", version="x", project="x"))
    task_mod.insert(store, Task(id="x", display_name="seed-task", project="x", version="x",
                                build_id="x", build_variant="v1", distro_id="x"))
    host_mod.insert(store, Host(id="x", distro_id="x"))
    user_mod.coll(store).insert(User(id="x", display_name="Seed").to_doc())
    store.collection("project_refs").insert({"_id": "x", "enabled": True, "branch": "main"})
    store.collection("patches").insert(
        Patch(id="x", project="x", author="x", description="seed patch").to_doc())
    store.collection("task_logs").insert(
        {"_id": "x", "lines": ["hello", "[agent] hi", "[system] sys"]})
    host_mod.insert(store, Host(id="sh1", distro_id="x", provider="mock", status="stopped",
                                user_host=True, started_by=PAGE_USER[0]))
    for vol in (Volume(id="x", created_by=PAGE_USER[0], size_gb=8, host_id="sh1"),
                Volume(id="vol-att", created_by=PAGE_USER[0], size_gb=8),
                Volume(id="vol-free", created_by=PAGE_USER[0], size_gb=8)):
        store.collection("volumes").insert(vol.to_doc())
    user_mod.coll(store).insert(User(id=PAGE_USER[0], api_key=PAGE_USER[1],
                                     roles=["superuser"]).to_doc())


def gql(env, hdr, doc, variables=None) -> tuple:
    """One ``POST /graphql`` through ``env``'s ``RestApi.handle``: (status,
    the answer through JSON, the ``extensions`` it carried, popped)."""
    st, out = env.api.handle("POST", "/graphql", {"query": doc, "variables": variables or {}},
                             dict(hdr))
    out = json.loads(json.dumps(out))
    return st, out, out.pop("extensions", None) if isinstance(out, dict) else None


def queue_items(store, did) -> list:
    from evergreen_tpu_torch.models import task_queue

    q = task_queue.load(store, did)
    return q.queue if q is not None else []


def gql_sequence(envs, enter, leave, now, doomed, deactivated, version) -> dict:
    """Phase 12's GraphQL round before the ticks of round ``GQL_ROUND``,
    through each environment's ``RestApi.handle`` (``POST /graphql``) with
    the API user's (superuser) key, in the same order on (a) and (b):
    ``setTaskPriority`` to ``GQL_PRIORITY`` on the last ``GQL_RAISED``
    queued tasks of the longest queue outside any task group with their
    dependencies met, ``unscheduleTask`` on its first, ``scheduleTasks``
    on ``GQL_SCHEDULED`` of the tasks the admin round's abort deactivated,
    ``copyDistro`` of that distro (the set grows back past the admin
    round's delete) and ``saveAdminSettings`` of the banner; then, each
    follower caught up, the queries ``taskQueue``, ``distroTaskQueue``,
    ``taskQueueDistros``, ``version`` and ``versionTasks`` (of the pushed
    ``version``), ``waterfall`` (of its project) and ``spruceConfig``,
    served by the follower (``extensions.served_by``).
    Holds every answer without errors and (a)'s equal to (b)'s; returns
    what ``gql_checks`` holds after the ticks."""
    hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
    a = envs["a"]
    lengths = {d["_id"]: len(queue_items(a.store, d["_id"]))
               for d in a.store.collection("task_queues").find() if d["_id"] != doomed}
    target = max(lengths, key=lambda k: (lengths[k], k))
    items = queue_items(a.store, target)
    raised = [i.id for i in items if not i.task_group and i.dependencies_met][-GQL_RAISED:]
    unscheduled = next(i.id for i in items if i.id not in raised)
    scheduled = sorted(deactivated)[:GQL_SCHEDULED]
    check(len(raised) == GQL_RAISED and len(scheduled) == GQL_SCHEDULED,
          f"graphql: {len(raised)} tasks to raise in {target}, {len(scheduled)} to schedule")
    copy_id = f"{target}-copy"
    project = a.store.collection("versions").get(version)["project"]
    writes = [(f"mutation($t: String!, $p: Int!) {{ setTaskPriority(taskId: $t, "
               f"priority: $p) {{ id priority }} }}", {"t": t, "p": GQL_PRIORITY})
              for t in raised]
    writes += [
        ("mutation($t: String!) { unscheduleTask(taskId: $t) { id activated } }",
         {"t": unscheduled}),
        ("mutation($ts: [String!]!) { scheduleTasks(taskIds: $ts) { id activated } }",
         {"ts": scheduled}),
        ("mutation($o: CopyDistroInput!) { copyDistro(opts: $o) { newDistroId } }",
         {"o": {"distroIdToCopy": target, "newDistroId": copy_id}}),
        ("mutation($s: JSON!) { saveAdminSettings(adminSettings: $s) }",
         {"s": {"banner": dict(GQL_BANNER)}})]
    reads = [
        ("query($d: String!) { taskQueue(distroId: $d) { id task_group dependencies_met } }",
         {"d": target}),
        ("query($d: String!) { distroTaskQueue(distroId: $d) { id } }", {"d": target}),
        ("{ taskQueueDistros { id taskCount hostCount } }", {}),
        ("query($v: String!) { version(versionId: $v) { id project status requester } }",
         {"v": version}),
        ("query($v: String!) { versionTasks(versionId: $v, limit: 50) { totalCount "
         "filteredCount tasks { id status priority } } }", {"v": version}),
        ("query($p: String!) { waterfall(projectId: $p, limit: 5) { id order status "
         "build_variants { name total success failed in_progress } } }", {"p": project}),
        ("{ spruceConfig { banner bannerTheme } }", {})]
    got, ms, served = {}, {}, {}

    def send(key, env, calls):
        for doc, variables in calls:
            t0 = time.perf_counter()
            st, out, ext = gql(env, hdr, doc, variables)
            ms[key].append((time.perf_counter() - t0) * 1e3)
            check(st == 200 and "errors" not in out, f"graphql ({key}): {doc[:60]} answered "
                  f"{st} {str(out)[:300]}")
            got[key].append(out)
            served[key].append((ext or {}).get("served_by"))

    with checking_credentials(envs):
        for key, env in envs.items():
            got[key], ms[key], served[key] = [], [], []
            enter(key, now)
            try:
                send(key, env, writes)
            finally:
                leave()
        caught = catch_up(envs, "graphql")
        for key, env in envs.items():
            enter(key, now)
            try:
                send(key, env, reads)
            finally:
                leave()
    diff = [k for k, (x, y) in enumerate(zip(got["a"], got["b"])) if x != y]
    check(not diff and len(got["a"]) == len(got["b"]),
          f"graphql: the answers of (a) and (b) differ at {diff}: "
          f"{str([got['a'][k] for k in diff])[:400]} against "
          f"{str([got['b'][k] for k in diff])[:400]}")
    for key, env in envs.items():
        rid = env.api.read_replica.replica_id
        check(served[key][len(writes):] == [rid] * len(reads)
              and served[key][:len(writes)] == [None] * len(writes),
              f"graphql ({key}): served by {served[key]}, the follower is {rid}")
    out = dict(zip([f"w{k}" for k in range(len(writes))] + [f"r{k}" for k in range(len(reads))],
                   got["a"]))
    check(all(x["data"]["setTaskPriority"]["priority"] == GQL_PRIORITY
              for x in got["a"][:GQL_RAISED])
          and [t["activated"] for t in got["a"][GQL_RAISED + 1]["data"]["scheduleTasks"]]
          == [True] * GQL_SCHEDULED
          and got["a"][GQL_RAISED + 2]["data"]["copyDistro"] == {"newDistroId": copy_id}
          and got["a"][-1]["data"]["spruceConfig"] == {
              "banner": GQL_BANNER["text"], "bannerTheme": GQL_BANNER["theme"]},
          f"graphql: the mutations' answers {str(got['a'][:len(writes)])[:600]}")
    dists = {d["id"]: d for d in got["a"][len(writes) + 2]["data"]["taskQueueDistros"]}
    check(copy_id in dists and dists[copy_id]["taskCount"] == 0
          and dists[target]["taskCount"] == len(items),
          f"graphql: taskQueueDistros of {target} and its copy: "
          f"{dists.get(target)}, {dists.get(copy_id)}")
    return {"target": target, "raised": raised, "unscheduled": unscheduled,
            "scheduled": scheduled, "copy": copy_id, "before": [i.id for i in items],
            "ms": ms, "caught": caught, "n": len(writes) + len(reads), "out": out}


def gql_checks(envs, r, g, cold) -> str:
    """After round ``GQL_ROUND``'s ticks, whose documents in (a) and (b)
    are already held equal: in the queue the card wrote, each raised task
    moved up and one of them leads (the planner ranks units: a version's
    tasks, a task group), the unscheduled task is gone, and each task
    scheduled again is queued or handed out; the copy is in the tick's
    distro set with a queue document of its own, and the resident planes
    of (a) and (b) counted the same rebuilds and splices; (a)'s queue
    documents equal ``cold``'s (a cold tick of the same store, their
    task-group infos in name order, without ``dirty_at``: a dependency
    wake's stamp for the dispatchers, which the warm tick's patch of a
    document keeps and a cold tick's rewrite drops). Returns a line for
    the log."""
    from evergreen_tpu_torch.scheduler import resident

    a = envs["a"]
    new = [i.id for i in queue_items(a.store, g["target"])]
    old = g["before"]
    check(new and new[0] in g["raised"]
          and all(new.index(t) < old.index(t) for t in g["raised"]),
          f"round {r}: the raised tasks at {[new.index(t) if t in new else None for t in g['raised']]} "
          f"of {g['target']}'s queue, before at {[old.index(t) for t in g['raised']]}")
    check(g["unscheduled"] not in new, f"round {r}: {g['unscheduled']} still queued")
    rows = queue_rows(a.store)
    tasks = a.store.collection("tasks")
    check(all(t in rows or tasks.get(t)["status"] != "undispatched" for t in g["scheduled"]),
          f"round {r}: the scheduled tasks {g['scheduled']} neither queued nor handed out")
    check(a.store.collection("task_queues").get(g["copy"]) is not None,
          f"round {r}: no queue document of {g['copy']}")
    planes = {k: resident.peek_resident_plane(e.store).stats() for k, e in envs.items()}
    keys = ("rebuilds", "rebuild_reasons", "topology_splices", "fallbacks")
    check(all(planes["a"].get(k) == planes["b"].get(k) for k in keys),
          f"round {r}: the resident planes differ: "
          f"{ {k: (planes['a'].get(k), planes['b'].get(k)) for k in keys} }")
    n = 0
    for name in ("task_queues", "task_secondary_queues"):
        warm, got = ([{k: v for k, v in infos_by_name(d).items() if k != "dirty_at"}
                      for d in s.collection(name).find()] for s in (a.store, cold))
        k = next((i for i, (x, y) in enumerate(zip(warm, got)) if x != y), None)
        fields = [] if k is None else sorted(
            f for f in set(warm[k]) | set(got[k]) if warm[k].get(f) != got[k].get(f))
        check(len(warm) == len(got) and k is None,
              f"round {r}: (a)'s {name} differ from a cold tick's ({len(warm)} and "
              f"{len(got)} documents; the first at {k}, in {fields}: "
              f"{json.dumps({f: warm[k].get(f) for f in fields}, default=str)[:300]} "
              f"against {json.dumps({f: got[k].get(f) for f in fields}, default=str)[:300]})")
        n += len(warm)
    return (f"in {g['target']}'s queue the raised tasks at "
            f"{[new.index(t) for t in g['raised']]} (before "
            f"{[old.index(t) for t in g['raised']]}), {g['unscheduled']} gone, the "
            f"scheduled {g['scheduled']} queued or handed out; {g['copy']} planned; the "
            f"resident planes (a) = (b) { {k: planes['a'].get(k) for k in keys} }; "
            f"{n} queue documents of (a) equal a cold tick's (infos by name)")


def page_round(envs, enter, leave, now) -> dict:
    """Every document the page embeds (``api/ui.py::documents``) through
    each environment's ``POST /graphql`` as ``PAGE_USER``, in page order,
    on the entities ``page_world`` seeds (each follower caught up before
    a query): no answer errors, and (a)'s equal (b)'s."""
    from evergreen_tpu_torch.api import ui

    hdr = {"api-user": PAGE_USER[0], "api-key": PAGE_USER[1]}
    docs = ui.documents()
    got, ms = {k: [] for k in envs}, {k: [] for k in envs}
    for key, env in envs.items():
        enter(key, now)
        try:
            page_world(env.store)
        finally:
            leave()
    with checking_credentials(envs):
        for doc in docs:
            if not doc.startswith("mutation"):
                catch_up(envs, "page")
            for key, env in envs.items():
                enter(key, now)
                try:
                    t0 = time.perf_counter()
                    st, out, _ = gql(env, hdr, doc, page_variables(doc))
                    ms[key].append((time.perf_counter() - t0) * 1e3)
                finally:
                    leave()
                check(st == 200 and "errors" not in out,
                      f"page ({key}): {doc[:80]} answered {st} {str(out)[:300]}")
                got[key].append(out)
    diff = [k for k, (x, y) in enumerate(zip(got["a"], got["b"])) if x != y]
    check(not diff, f"page: the answers of (a) and (b) differ at {diff}: "
          f"{str([got['a'][k] for k in diff])[:400]}")
    return {"n": len(docs), "mutations": sum(d.startswith("mutation") for d in docs),
            "ms": ms}


def store_copy(store):
    """An in-memory ``Store`` holding a copy of every document of
    ``store``."""
    import copy

    from evergreen_tpu_torch.storage.store import Store

    out = Store()
    for name in sorted(store._collections):
        out.collection(name).insert_many(copy.deepcopy(store.collection(name).find()))
    return out


def cron_phase(torch, np, problem, card="cuda", root=DATA_ROOT, on_seed=None) -> dict:
    """Phase 12: the service's job plane (``env.py::Environment.build``,
    ``JobQueue``, ``CronRunner`` and the populators of ``units/crons.py``)
    on a durable directory, with (a)'s REST agent surface
    (``api/rest.py``, host credentials required) on a socket: the agent
    pass after round ``CRON_AGENT_AFTER`` goes over HTTP on (a) and
    through ``LocalCommunicator`` on (b), and the pool round runs a
    concurrent burst of agents over HTTP. The ingestion plane feeds the
    rounds (``ingest_push``, ``ingest_generator``, ``ingest_more``,
    ``ingest_checks``), and after each round ``read_round`` reads every
    cached route through both environments. Returns the card environment's launches: round
    1's as ``"cron"``, the later rounds' and the pool round's as
    ``"ingest"``. ``card="cpu"``
    rehearses it on the CPU. The pool's and the fault's rounds run on a
    clock that moves on from the pinned rounds' (a jump to the wall clock
    would read as tick lag to the overload ladder). ``on_seed(seed_dir)``
    runs once the seeded directory is written (phase 13 copies it)."""
    import contextlib
    import dataclasses
    import io
    import itertools
    import random
    import shutil
    import threading
    import uuid

    from evergreen_tpu_torch.agent.agent import Agent, AgentOptions
    from evergreen_tpu_torch.agent.comm import LocalCommunicator
    from evergreen_tpu_torch.agent.rest_comm import RestCommunicator
    from evergreen_tpu_torch.cloud.mock import MockCloudManager
    from evergreen_tpu_torch.dispatch import longpoll
    from evergreen_tpu_torch.dispatch.dag_dispatcher import DispatcherService
    from evergreen_tpu_torch.env import Environment
    from evergreen_tpu_torch.events import triggers
    from evergreen_tpu_torch.ingestion import merge_queue, patches
    from evergreen_tpu_torch.ingestion import project as project_mod
    from evergreen_tpu_torch.ingestion import repotracker
    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import lifecycle
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.models import task_queue
    from evergreen_tpu_torch.ops import distro_stats
    from evergreen_tpu_torch.ops._build import KernelError
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.queue import jobs as jobs_mod
    from evergreen_tpu_torch.scheduler import capacity_plane, resident, wrapper
    from evergreen_tpu_torch.settings import (
        AmboyConfig,
        CapacityConfig,
        HostInitConfig,
        OverloadConfig,
    )
    from evergreen_tpu_torch.storage.lease import FileLease
    from evergreen_tpu_torch.units import crons
    from evergreen_tpu_torch.utils import log as log_mod
    from evergreen_tpu_torch.utils import overload, tracing
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    devices = {k: (card if d == "cuda" else "cpu") for k, d in CRON_ENVS}
    iters = CapacityConfig().iterations
    solve_launches = (expected_launches([iters]) if on_card
                      else {"fused_distro_stats": 0, "segment_sum": 0})
    no_launches = {"fused_distro_stats": 0, "segment_sum": 0}
    throttle = HostInitConfig().host_throttle
    shutil.rmtree(root, ignore_errors=True)
    seed_dir = os.path.join(root, "cron-seed")
    t0 = time.perf_counter()
    up, seeded, in_flight = seed_cron_dir(problem, seed_dir)
    seed_ms = (time.perf_counter() - t0) * 1e3
    if on_seed is not None:
        on_seed(seed_dir)
    dirs = {}
    for key, _ in CRON_ENVS:
        dirs[key] = os.path.join(root, f"cron-{key}")
        shutil.copytree(seed_dir, dirs[key])
    log(f"cron: config 3 (seed {SEED}) with phase 6's capacity settings seeded into a "
        f"durable directory in {seed_ms:.0f} ms ({len(up)} running hosts with a mock "
        f"instance), copied for (a) the card's environment and (b) the CPU's; version "
        f"{seeded} has the parser project, {len(in_flight)} of its tasks in flight")

    # the process-wide state each environment keeps apart: its uuid4
    # stream, event sequence, mock cloud table and log sink; the clock is
    # pinned around every step of either
    cloud0 = {f"mock-{hid}": "running" for hid in up}
    state = {k: dict(rng=random.Random(12_000), seq=itertools.count(),
                     cloud=dict(cloud0), sinks=[], patch_seq=itertools.count(1),
                     ntf_seq=itertools.count(), senders={})
             for k, _ in CRON_ENVS + (("cold", "cuda"),)}
    real_uuid4, real_time = uuid.uuid4, time.time
    real_cloud, real_patch_seq = MockCloudManager.instances, patches._patch_seq

    def enter(key, now):
        """Install ``key``'s process-wide state; the clock reads ``now``,
        or runs on from it when ``moving``."""
        st = state[key]
        uuid.uuid4 = lambda: uuid.UUID(int=st["rng"].getrandbits(128))
        if isinstance(now, tuple):
            offset = real_time() - now[1]
            time.time = lambda: real_time() - offset
        else:
            time.time = lambda: now
        event_mod._SEQ = st["seq"]
        MockCloudManager.instances = st["cloud"]
        patches._patch_seq = st["patch_seq"]
        # the notification sequence and the senders, which each build
        # registers process-wide bound to its own store
        triggers._seq = st["ntf_seq"]
        triggers._SENDERS.clear()
        triggers._SENDERS.update(st["senders"])
        log_mod.reset_sinks(*st["sinks"])

    def leave():
        uuid.uuid4, time.time = real_uuid4, real_time

    envs, boots, server, sink = {}, {}, None, None
    real_senders = dict(triggers._SENDERS)
    try:
        for key, _ in CRON_ENVS:
            enter(key, NOW)
            lines = io.StringIO()
            try:
                t0 = time.perf_counter()
                # the JSON-line sink the build wires writes to stderr: the
                # recovery pass's record names every claim it released
                with contextlib.redirect_stderr(lines):
                    envs[key] = Environment.build(data_dir=dirs[key], workers=1,
                                                  device=devices[key],
                                                  require_auth=key == "a")
                boots[key] = (time.perf_counter() - t0) * 1e3
                state[key]["senders"] = dict(triggers._SENDERS)
            finally:
                leave()
            # the build wired the JSON-line sink and the store's ring; the
            # rounds keep the ring alone (two environments share this
            # process, where a service has one)
            state[key]["sinks"] = [s for s in log_mod._sinks
                                   if isinstance(s, log_mod.StoreSink)]
            log_mod.reset_sinks()
            e = envs[key]
            log(f"cron: Environment.build (({key}), {devices[key]}) {boots[key]:.1f} ms: "
                + ", ".join(f"{p} {ms:.1f}" for p, ms in e.boot_ms.items())
                + f" ms; {len(lines.getvalue().splitlines())} JSON log lines; lease "
                f"epoch {e.store.epoch}; migrations "
                f"{[r for _, r in e.migrations]}; recovery "
                f"{recovery_counts(e.recovery_report)}")
        a, b = envs["a"], envs["b"]
        followers = {k: e.api.read_replica for k, e in envs.items()}
        check(all(f is not None and f.data_dir == dirs[k] and f.poll_interval_s == 0.25
                  and f._thread is not None for k, f in followers.items())
              and followers["a"] is not followers["b"],
              "a durable environment has no follower of its own directory")
        # each build drew its follower's id from its environment's pinned
        # uuid4 stream, the same in (a) and (b): the ids agree here
        log(f"cron: each environment's API has its follower, a ReplicaStore of its own "
            f"directory polled every {followers['a'].poll_interval_s} s: (a) "
            f"{followers['a'].replica_id}, (b) {followers['b'].replica_id}")
        # (a)'s REST surface on a socket; agents authenticate with the
        # secrets the migration 0003-backfill-host-secrets minted
        by_route = timed_routes(a.api)
        server = a.api.serve("127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        check(a.dispatcher is a.api.svc, "Environment.dispatcher is not the API's")
        log(f"cron: (a) serves its REST agent surface at {base} (host credentials "
            f"required); {len(a.api._routes)} routes")
        check(a.recovery_report.to_doc() == b.recovery_report.to_doc(),
              "the recovery reports differ")
        check(a.queue._workers == 1 and b.queue._workers == 1, "not one worker")
        same_cron_docs(a.store, b.store, "after the build")
        # the event plane's outside world, and what each environment sends
        sink = LocalSink()
        for key, env in envs.items():
            enter(key, NOW)
            try:
                seed_event_plane(env.store, sink.url, seeded)
            finally:
                leave()
        log(f"cron: egress on in (a) and (b), the webhook (HMAC-signed), Slack, Jira and "
            f"GitHub-status channels aimed at a local sink ({sink.url}), email left in its "
            f"outbox; {len(cron_subscriptions(sink.url, seeded))} subscriptions seeded")
        scraped = parse_exposition(http_text(base, "/metrics")[2])

        fused = (fused_distro_stats, segment_sum)
        # round 1's launches, then those of the ticks after the push, and
        # the cold tick the GraphQL round's queues are held to
        launches = {"cron": {}, "ingest": {}, "cold": {}}
        P = INGEST_PROJECT_ID
        distro_ids = [d.id for d in problem[0]]
        ingest = {}
        seen_runs = {k: set() for k in envs}

        def job_runs(key):
            """This round's ``job.run`` ring spans of ``key``: type -> ms."""
            out = {}
            for _, spans in tracing.trace_ring_for(envs[key].store).traces():
                for s in spans:
                    if s.get("name") == "job.run" and s["_id"] not in seen_runs[key]:
                        seen_runs[key].add(s["_id"])
                        jt = s["attributes"]["job_type"]
                        out[jt] = out.get(jt, 0.0) + s["duration_ms"]
            return out

        def counters():
            return (wrapper.TICK_DEGRADED.total(),
                    capacity_plane.CAPACITY_FALLBACKS.total())

        def round_checks(key, label, events0, n_jobs):
            """A round's own checks on ``key``: no failed job, every job
            completed, each tick span planned by the card (or the CPU) and
            not degraded, and ``host-create`` spawning what the throttle
            allows. Returns (spawned, provisioned)."""
            store = envs[key].store
            new = store.collection("events").find()[events0:]
            check(not any(e["event_type"] == "JOB_FAILED" for e in new),
                  f"round {label} ({key}): a job failed")
            recs = store.collection("jobs").find()
            check(all(r["status"] == "completed" for r in recs),
                  f"round {label} ({key}): job statuses "
                  f"{sorted({r['status'] for r in recs})}")
            check(len(recs) == n_jobs, f"round {label} ({key}): {len(recs)} job records, "
                  f"expected {n_jobs}")
            last = [s for s in store.collection("spans").find()
                    if s["name"] == "tick"][-1]["attributes"]
            check((last["planner_used"], last["degraded"]) == ("tpu", ""),
                  f"round {label} ({key}): the tick job's planner "
                  f"{last['planner_used']!r}, degraded {last['degraded']!r}")
            spawned = sorted(e["resource_id"] for e in new if e["event_type"] == "HOST_STARTED")
            provisioned = sorted(e["resource_id"] for e in new
                                 if e["event_type"] == "HOST_PROVISIONED")
            left = store.collection("hosts").count(lambda d: d["status"] == "initializing")
            check(len(spawned) == min(throttle, len(spawned) + left),
                  f"round {label} ({key}): host-create spawned {len(spawned)} with "
                  f"{left} intents left, throttle {throttle}")
            return spawned, provisioned

        peaks = {}
        for key, env in envs.items():
            real_backlog = env.store.flush_backlog

            def backlog(real=real_backlog, key=key):
                n = real()
                peaks[key] = max(peaks.get(key, 0), n)
                return n

            env.store.flush_backlog = backlog
        n_jobs = {k: 0 for k in envs}
        read_seen = {k: {} for k in envs}
        for r in range(1, CRON_ROUNDS + 1):
            peaks.clear()
            label, now = str(r), NOW + CRON_ROUND_AT[r - 1]
            walls, runs, made = {}, {}, {}
            if r == INGEST_PUSH_ROUND:
                ingest = ingest_push(envs, base, enter, leave, now, distro_ids, project_mod)
                same_cron_docs(a.store, b.store, "the push")
            elif r == INGEST_MORE_ROUND:
                ingest.update(ingest_more(envs, base, enter, leave, now, distro_ids,
                                          ingest, repotracker, merge_queue))
                same_cron_docs(a.store, b.store, "the patch and the merge group")
            if r == SPAWN_ROUND:
                spawn_ids = {"d": distro_ids[0]}
                spawn_ms = spawn_sequence(envs, enter, leave, now, SPAWN_OPEN, spawn_ids,
                                          "open")
                same_cron_docs(a.store, b.store, "the spawn host and its volume")
            if r == ADMIN_ROUND:
                # the last distro with queued tasks whose hosts run none, of
                # those the round's other steps leave alone
                others = set(distro_ids[:max(READ_DISTROS, 2 + INGEST_PATCH_VARIANTS
                                             + INGEST_MERGE_VARIANTS)])
                busy = {d["distro_id"] for d in a.store.collection("hosts").find()
                        if d["running_task"]}
                queued = {d for d, _, _ in queue_rows(a.store).values()}
                doomed = next((d for d in reversed(distro_ids)
                               if d in queued and d not in others | busy), None)
                check(doomed is not None, "admin: no distro with queued tasks and idle "
                      "hosts to delete")
                hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
                admin_before = {
                    "n_distros": [d["attributes"] for d in a.store.collection("spans").find()
                                  if d["name"] == "tick"][-1]["n_distros"],
                    "fleet": a.api.handle("GET", "/rest/v2/admin/capacity", {"limit": 0},
                                          dict(hdr))[1]["fleet"]}
                admin = admin_sequence(envs, enter, leave, now, ingest, seeded, doomed)
                same_cron_docs(a.store, b.store, "the admin round")
            if r == GQL_ROUND:
                graphql = gql_sequence(envs, enter, leave, now, doomed,
                                       admin["abort"]["deactivated"], ingest["version"])
                same_cron_docs(a.store, b.store, "the graphql round")
                # (a)'s store as its round's tick job will read it, for a
                # cold tick of the same inputs after the round
                t0 = time.perf_counter()
                cold_store = store_copy(a.store)
                cold_copy_ms = (time.perf_counter() - t0) * 1e3
            deliveries = {}
            for key, env in envs.items():
                events0 = len(env.store.collection("events"))
                deg0 = counters()
                posts0 = len(sink.posts)
                enter(key, now)
                reset_launches(*fused)
                if r == ADMIN_ROUND and key == "a":
                    # the card plane's sync of this tick, for admin_checks
                    syncs, undo_syncs = service_tick_inputs(resident.ResidentPlane)
                t0 = time.perf_counter()
                try:
                    n_jobs[key] += env.cron_runner.tick(force=True)
                    check(env.queue.wait_idle(timeout_s=300.0), f"round {label} ({key}) "
                          f"did not finish")
                finally:
                    leave()
                    if r == ADMIN_ROUND and key == "a":
                        undo_syncs()
                walls[key] = (time.perf_counter() - t0) * 1e3
                deliveries[key] = sink_deliveries(sink.posts[posts0:], f"round {label} ({key})")
                got = read_launches(*fused)
                want = solve_launches if devices[key] != "cpu" else no_launches
                check(got == want, f"round {label} ({key}): launches {got}, expected "
                      f"{want}")
                if devices[key] != "cpu":
                    add_launches(launches["cron" if r < INGEST_PUSH_ROUND else "ingest"], got)
                check(counters() == deg0, f"round {label} ({key}): a degradation or "
                      f"fallback counter moved")
                plane = resident.peek_resident_plane(env.store)
                check(plane is not None and plane.stats()["fallbacks"] == 0,
                      f"round {label} ({key}): resident plane fallback")
                made[key] = round_checks(key, label, events0, n_jobs[key])
                runs[key] = job_runs(key)
            check(made["a"] == made["b"], f"round {label}: the hosts spawned and "
                  f"provisioned differ")
            n_docs = same_cron_docs(a.store, b.store, f"round {label}")
            log(f"cron round {label}: {n_jobs['a']} jobs so far, all completed, none "
                f"failed; host-create spawned {len(made['a'][0])} (throttle {throttle}) "
                f"and provisioned {len(made['a'][1])} mock hosts, the same in (a) and (b); "
                f"tick planned by the card in (a), no degradation; {n_docs} documents "
                f"and the span documents equal; launches exact "
                f"({solve_launches['fused_distro_stats']} + "
                f"{solve_launches['segment_sum']} in (a))")
            log(f"cron round {label} wall ms (a) {walls['a']:.1f}, (b) {walls['b']:.1f}; "
                f"the WAL flusher's peak backlog as the ladder read it (a) "
                f"{peaks.get('a', 0)}, (b) {peaks.get('b', 0)} frames; "
                f"job run ms (a) / (b): " + "; ".join(
                    f"{jt} {runs['a'][jt]:.1f} / {runs['b'].get(jt, 0.0):.1f}"
                    for jt in sorted(runs["a"])))
            check(deliveries["a"] == deliveries["b"], f"round {label}: the sink's deliveries "
                  f"differ ({len(deliveries['a'])} and {len(deliveries['b'])})")
            status, ctype, text = http_text(base, "/metrics")
            now_scraped = parse_exposition(text)
            moved = {n: series_sum(now_scraped, n) - series_sum(scraped, n) for n in (
                "scheduler_ticks_total", "scheduler_tick_duration_ms_count",
                "events_delivery_failed_total")}
            check(ctype == "text/plain; version=0.0.4; charset=utf-8"
                  and moved == {"scheduler_ticks_total": 2.0,
                                "scheduler_tick_duration_ms_count": 2.0,
                                "events_delivery_failed_total": 0.0},
                  f"round {label}: /metrics ({ctype}) moved {moved}")
            scraped = now_scraped
            outbox = {c: sum(1 for d in a.store.collection(c).find() if d["delivered"])
                      for c in ("webhook_outbox", "slack_outbox", "jira_outbox",
                                "github_status_outbox", "email_outbox")}
            log(f"cron round {label} events: notifier ms (a) "
                f"{runs['a'].get('event-notifier', 0.0):.1f} / (b) "
                f"{runs['b'].get('event-notifier', 0.0):.1f}, drain ms (a) "
                f"{runs['a'].get('outbox-drain', 0.0):.1f} / (b) "
                f"{runs['b'].get('outbox-drain', 0.0):.1f}; "
                f"{len(a.store.collection('notifications'))} notifications so far, delivered "
                f"rows by outbox {outbox} (of "
                f"{ {c: len(a.store.collection(c)) for c in outbox} }); this round "
                f"{len(deliveries['a'])} sink deliveries, the same in (a) and (b), each "
                f"webhook's signature its body's HMAC; /metrics (over HTTP) moved "
                f"{moved}")
            if r == SPAWN_ROUND:
                # the round's ticks ran with the user's spawn host in the
                # hosts collection; now the volume goes and the host ends
                for key, ms_ in spawn_sequence(envs, enter, leave, now, SPAWN_CLOSE,
                                               spawn_ids, "close").items():
                    spawn_ms[key] += ms_
                n_spawn = same_cron_docs(a.store, b.store, "the spawn host's end")
                catch_up(envs, "spawn")
                hdr = {"api-user": INGEST_USER[0], "api-key": INGEST_USER[1]}
                for key, env in envs.items():
                    st_h, h = env.api.handle("GET", f"/rest/v2/hosts/{spawn_ids['h']}", {},
                                             dict(hdr))
                    served = dict(env.api._ident.response_headers).get("X-Evg-Served-By")
                    st_v, vols = env.api.handle("GET", "/rest/v2/volumes", {}, dict(hdr))
                    check(st_h == st_v == 200 and h["status"] == "terminated"
                          and h["user_host"] and h["started_by"] == INGEST_USER[0]
                          and served == followers[key].replica_id
                          and spawn_ids["v"] not in [x["_id"] for x in vols],
                          f"spawn ({key}): the follower reads {st_h} {h.get('status')} "
                          f"(served by {served}), {st_v} volumes {vols}")
                log(f"cron round {label} spawn host: {len(SPAWN_OPEN)} requests before the "
                    f"round's ticks (spawn {spawn_ids['h']} on {spawn_ids['d']}, extend, "
                    f"stop, start, volume {spawn_ids['v']}, attach) and "
                    f"{len(SPAWN_CLOSE)} after (detach, delete, terminate) through "
                    f"RestApi.handle, each 200, the answers equal in (a) and (b); the "
                    f"ticks planned on the card over it, launches exact, no degradation; "
                    f"{n_spawn} documents equal after; the followers read it terminated "
                    f"and the volume gone; ms a request (a) "
                    f"{', '.join(f'{x:.1f}' for x in spawn_ms['a'])}, (b) "
                    f"{', '.join(f'{x:.1f}' for x in spawn_ms['b'])}")
            if r == ADMIN_ROUND:
                held = admin_checks(envs, label, doomed, admin_before, syncs, np,
                                    added=(graphql["copy"],))
                log(f"cron round {label} admin: before the ticks, through RestApi.handle "
                    f"in (a) and (b) with the superuser's key, the pushed version aborted "
                    f"({len(admin['abort']['deactivated'])} tasks deactivated, "
                    f"{len(admin['abort']['aborted'])} in flight flagged) and restarted "
                    f"({admin['restart']['restarted']}), {doomed} refused 409 with live "
                    f"hosts, drained and deleted, the capacity budget set to {ADMIN_BUDGET} "
                    f"and task limits {ADMIN_LIMITS}, a failed task annotated, "
                    f"{INGEST_PROJECT_ID} copied to {ADMIN_COPY} with its variables (a dry "
                    f"run of the private one), then read back after the catch-up "
                    f"({admin['caught']['a'][0]} / {admin['caught']['b'][0]} records): the "
                    f"annotation, {len(admin['rel'])} reliability groups, the copy's event, "
                    f"the settings; every answer (a) = (b); ms a request (a) "
                    f"{', '.join(f'{x:.1f}' for x in admin['ms']['a'])}, (b) "
                    f"{', '.join(f'{x:.1f}' for x in admin['ms']['b'])}")
                log(f"cron round {label} admin, after the ticks: {held}")
            if r == GQL_ROUND:
                # the cold tick: the tick job's options without the cache,
                # on the copy, at the round's clock, on its own id stream
                enter("cold", now)
                reset_launches(*fused)
                t0 = time.perf_counter()
                try:
                    cold_res = wrapper.run_tick(
                        cold_store, dataclasses.replace(crons.service_tick_options(),
                                                        use_cache=False),
                        now=now, device=devices["a"])
                finally:
                    leave()
                cold_ms = (time.perf_counter() - t0) * 1e3
                got = read_launches(*fused)
                check(got == solve_launches and (cold_res.planner_used, cold_res.degraded)
                      == ("tpu", ""), f"round {label}: the cold tick's launches {got}, "
                      f"planner {cold_res.planner_used!r}, degraded {cold_res.degraded!r}")
                add_launches(launches["cold"], got)
                # the cold tick counted in this process's registry: the next
                # round's scrape moves from here
                scraped = parse_exposition(http_text(base, "/metrics")[2])
                held = gql_checks(envs, label, graphql, cold_store)
                del cold_store
                log(f"cron round {label} graphql: before the ticks, {graphql['n']} documents "
                    f"through POST /graphql in (a) and (b) with the superuser's key: "
                    f"setTaskPriority {GQL_PRIORITY} on {graphql['raised']} of "
                    f"{graphql['target']}, unscheduleTask {graphql['unscheduled']}, "
                    f"scheduleTasks {graphql['scheduled']} (deactivated by the abort), "
                    f"copyDistro {graphql['target']} to {graphql['copy']}, "
                    f"saveAdminSettings of the banner; then, the followers caught up "
                    f"({graphql['caught']['a'][0]} / {graphql['caught']['b'][0]} records), "
                    f"taskQueue, distroTaskQueue, taskQueueDistros, version, versionTasks, "
                    f"waterfall and spruceConfig, each served by the follower; every answer "
                    f"(a) = (b), none an error; ms a document (a) "
                    f"{', '.join(f'{x:.1f}' for x in graphql['ms']['a'])}, (b) "
                    f"{', '.join(f'{x:.1f}' for x in graphql['ms']['b'])}")
                log(f"cron round {label} graphql, after the ticks: {held}; the cold tick "
                    f"(the tick job's options, no cache, on a copy of (a) made in "
                    f"{cold_copy_ms:.0f} ms) {cold_ms:.0f} ms on the card, launches exact")
                page = page_round(envs, enter, leave, now)
                n_page = same_cron_docs(a.store, b.store, "the page's documents")
                log(f"cron round {label} page: the entities of the page's test seeded, then "
                    f"its {page['n']} documents ({page['mutations']} mutations) through POST "
                    f"/graphql in (a) and (b) as {PAGE_USER[0]}, in page order, each follower "
                    f"caught up before a query: no answer an error, every answer (a) = (b), "
                    f"{n_page} documents equal after; ms in all (a) "
                    f"{sum(page['ms']['a']):.1f}, (b) {sum(page['ms']['b']):.1f}")
            if r == 1:
                READINGS["cron first tick ms"] = runs["a"]["scheduler-tick"]
            READINGS["cron host-create ms"] = runs["a"]["host-create"]
            if r >= INGEST_PUSH_ROUND:
                ingest_checks(envs, r, ingest, runs, distro_ids, task_queue)
            if r == CRON_AGENT_AFTER:
                secrets = {d["_id"]: d["secret"] for d in a.store.collection("hosts").find()}
                svc_b = DispatcherService(b.store)
                comm_for = {
                    "a": lambda h: RestCommunicator(base, host_id=h, host_secret=secrets[h]),
                    "b": lambda h: LocalCommunicator(b.store, svc_b),
                }
                passes, seen = {}, {k: len(v) for k, v in by_route.items()}
                gen = ingest_generator(envs, enter, leave, now, task_mod, host_mod, lifecycle)
                for key, env in envs.items():
                    enter(key, now)
                    try:
                        passes[key] = comm_pass(env.store, comm_for[key],
                                                os.path.join(root, f"agent-{key}"))
                    finally:
                        leave()
                check(passes["a"][:2] == passes["b"][:2],
                      "agent pass: the finished tasks or the (host, task) pairs differ")
                finished, pairs = passes["a"][:2]
                ingest_generated(envs, gen, finished)
                statuses = sorted({s_ for _, s_ in finished})
                check(len(finished) == len(in_flight) + 1 and statuses == ["failed", "success"],
                      f"agent pass: finished {finished}")
                logs_a = [d for d in a.store.collection("task_logs").find()
                          if d["_id"] in dict(finished) and d["_id"] != gen[0]]
                check(len(logs_a) == len(in_flight) and all(
                    any(x.startswith(("ran ", "failing ")) for x in d["lines"]) for d in logs_a),
                    "agent pass: the seeded tasks' logs lack their commands' output")
                same_cron_docs(a.store, b.store, "agent pass")
                n_pulls, n_handed = len(pairs), sum(1 for _, t in pairs if t)
                pull_s = passes["a"][3] / 1e3
                log(f"cron agent pass after round {r}: {len(finished)} tasks in flight "
                    f"finished ({sum(1 for _, s_ in finished if s_ == 'failed')} failed; "
                    f"their commands ran, logs posted), then {n_pulls} pulls, "
                    f"{n_handed} tasks handed out; the pairs and every document equal in "
                    f"(a), over HTTP, and (b), through LocalCommunicator")
                log(f"cron agent pass wall ms (a) HTTP / (b) LocalCommunicator: finishing "
                    f"{passes['a'][2]:.1f} / {passes['b'][2]:.1f}, pulls {passes['a'][3]:.1f} "
                    f"/ {passes['b'][3]:.1f}; pulls a second over HTTP "
                    f"{n_pulls / max(pull_s, 1e-9):.0f} (in-process "
                    f"{n_pulls / max(passes['b'][3] / 1e3, 1e-9):.0f}); request ms p50 / p99 "
                    f"by route class on (a): " + route_stats(by_route, seen))
            # the read path after the round: every cached route through both
            # environments' REST surfaces, conditional on the last round's
            # ETags, with each follower first polled to its WAL's end
            caught = catch_up(envs, f"read {label}")
            reads = read_round(envs, enter, leave, now,
                               read_paths(a.store, distro_ids, seeded), read_seen, fused,
                               label)
            n_by = {c: reads["statuses"].count(c) for c in sorted(set(reads["statuses"]))}
            fol = reads["follower"]
            log(f"cron round {label} reads: {len(reads['statuses'])} conditional GETs "
                f"covering the 15 cached routes on (a) and (b), statuses {n_by} "
                f"(the same in both; each 200 then a cache hit), the payloads and the ETags "
                f"(store tag masked) equal; the queue routes' 304s exactly where the "
                f"persister's fingerprint and the stamps held; the cache counters moved by "
                f"the 304s and hits; no launch; ms p50 / max: (a) "
                f"{read_stats(reads['ms']['a'])}; (b) {read_stats(reads['ms']['b'])}")
            log(f"cron round {label} follower reads: the catch-up applied "
                f"{caught['a'][0]} / {caught['b'][0]} records in {caught['a'][1]:.1f} / "
                f"{caught['b'][1]:.1f} ms ((a) / (b)); the follower served "
                f"{fol['a'][0]:.0%} of (a)'s reads and {fol['b'][0]:.0%} of (b)'s, staleness "
                f"ms at each (a) {fol['a'][1]}, (b) {fol['b'][1]}")
            catch_up(envs, f"operator {label}")
            ops = operator_round(envs, enter, leave, now, distro_ids, fused, label)
            log(f"cron round {label} operator reads: {len(ops['statuses'])} routes "
                f"(provenance and capacity of {READ_DISTROS} distros, an explained task, "
                f"traces, ladder, stats, spans, log lines, events, fleet, probes) and two "
                f"scrapes on (a) and (b), statuses {ops['statuses']}; provenance and "
                f"capacity within rtol {ROUTE_RTOL}, the last tick's span tree and the "
                f"rest equal; api_requests_total moved exactly; no launch; ms (a) "
                f"{ops['ms']['a']:.1f}, (b) {ops['ms']['b']:.1f}")
        log(f"cron: the tick job's wall on (a) in round 1 {READINGS['cron first tick ms']:.1f} "
            f"ms, in round {CRON_ROUNDS} {runs['a']['scheduler-tick']:.1f} ms, against "
            f"phase 10's durable card tick after a churn "
            f"{READINGS.get('durable churn tick ms', float('nan')):.1f} ms; host-create "
            f"for {len(made['a'][0])} hosts {READINGS['cron host-create ms']:.1f} ms")

        # ---- (a) with the default pool and ladder: invariants ------------- #
        # the deployed ladder is back: its config re-read now, not at the
        # monitor's next refresh
        OverloadConfig().set(a.store)
        monitor = overload.monitor_for(a.store)
        monitor._cfg = None
        level0 = overload.level_name(monitor.level())
        deferred0 = {p: crons.CRON_DEFERRED.value(populator=p) for p in CRON_DEFERRERS}
        shed0 = jobs_mod.JOBS_SHED.total()
        events0 = len(a.store.collection("events"))
        pool = AmboyConfig.get(a.store).pool_size_local
        a.queue.close()
        a.queue = jobs_mod.JobQueue(a.store, workers=pool)
        a.cron_runner.queue = a.queue
        now = NOW + CRON_ROUND_AT[-1] + TICK_STEP_S
        peaks.clear()
        # the burst: an agent over HTTP on every free host, while the
        # round's tick job solves on the card
        from evergreen_tpu_torch.models import host as host_mod

        secrets = {d["_id"]: d["secret"] for d in a.store.collection("hosts").find()}
        free_hosts = sorted(h.id for h in host_mod.find(a.store)
                            if h.can_run_tasks() and not h.running_task)
        burst_hosts = free_hosts[:BURST_HOSTS]
        wakes0 = {o: longpoll.LONGPOLL_WAKES.value(outcome=o)
                  for o in ("work", "recheck", "timeout")}
        seen = {k: len(v) for k, v in by_route.items()}
        burst = {"pulls": 0, "handed": 0, "errors": []}
        burst_lock = threading.Lock()
        work = os.path.join(root, "agent-burst")

        def burst_agent(k):
            for hid in burst_hosts[k::BURST_THREADS]:
                try:
                    comm = RestCommunicator(base, host_id=hid, host_secret=secrets[hid])
                    tid = Agent(comm, AgentOptions(host_id=hid, work_dir=work)).run_once(
                        wait_s=BURST_WAIT_S)
                    with burst_lock:
                        burst["pulls"] += 1
                        burst["handed"] += tid is not None
                except Exception as exc:  # noqa: BLE001 — reported and failed below
                    with burst_lock:
                        burst["errors"].append(f"{hid}: {exc!r}")

        enter("a", ("moving", now))
        reset_launches(*fused)
        deg0 = counters()
        posts0 = len(sink.posts)
        recs0 = {d["_id"] for d in a.store.collection("jobs").find()}
        t0 = time.perf_counter()
        agents = [threading.Thread(target=burst_agent, args=(k,), daemon=True)
                  for k in range(BURST_THREADS)]
        try:
            for th in agents:
                th.start()
            n = a.cron_runner.tick(force=True)
            check(a.queue.wait_idle(timeout_s=300.0), "the pool round did not finish")
            pool_ms = (time.perf_counter() - t0) * 1e3
            for th in agents:
                th.join(timeout=120.0)
            burst_ms = (time.perf_counter() - t0) * 1e3
        finally:
            leave()
        check(not any(th.is_alive() for th in agents), "the burst's agents did not finish")
        pool_posts = sink_deliveries(sink.posts[posts0:], "pool round")
        check(not burst["errors"], f"burst: {burst['errors'][:3]}")
        check(burst["pulls"] == len(burst_hosts), f"burst: {burst['pulls']} pulls of "
              f"{len(burst_hosts)} hosts")
        wakes = {o: int(longpoll.LONGPOLL_WAKES.value(outcome=o) - v)
                 for o, v in wakes0.items()}
        log(f"cron burst on (a) during the pool round: {BURST_THREADS} agent threads over "
            f"HTTP on {len(burst_hosts)} of the {len(free_hosts)} free hosts; "
            f"{burst['pulls']} pulls "
            f"(Agent.run_once, wait {BURST_WAIT_S} s), {burst['handed']} handed out and "
            f"run to their end; wall {burst_ms:.1f} ms, "
            f"{burst['pulls'] / max(burst_ms / 1e3, 1e-9):.0f} pulls a second; parked pulls "
            f"ended by a wake {wakes['work']}, by a recheck {wakes['recheck']}, by the "
            f"deadline {wakes['timeout']}; request ms p50 / p99 by route class: "
            + route_stats(by_route, seen))
        got = read_launches(*fused)
        check(got == solve_launches, f"pool round: launches {got}, expected "
              f"{solve_launches}")
        add_launches(launches["ingest"], got)
        check(counters() == deg0, "pool round: a degradation or fallback counter moved")
        recs = [d for d in a.store.collection("jobs").find() if d["_id"] not in recs0]
        done = [d for d in recs if d["status"] == "completed"]
        shed = [d["type"] for d in recs if d["status"] == "shed"]
        check(len(done) == n and len(done) + len(shed) == len(recs),
              f"pool round: {len(recs)} records of {n} jobs admitted, statuses "
              f"{sorted({d['status'] for d in recs})}")
        check(len(shed) == jobs_mod.JOBS_SHED.total() - shed0,
              "pool round: the shed records and the shed counter differ")
        by_scope = {}
        for d in done:
            for s in d["scopes"]:
                by_scope.setdefault(s, []).append((d["started_at"], d["finished_at"]))
        for s, spans in by_scope.items():
            spans.sort()
            check(all(x[1] <= y[0] for x, y in zip(spans, spans[1:])),
                  f"pool round: two jobs holding scope {s!r} overlapped")
        runs = job_runs("a")
        check(sorted(runs) == sorted(d["type"] for d in done),
              "pool round: a job ran more or less than once")
        levels = [level0] + [e["resource_id"] for e in
                             a.store.collection("events").find()[events0:]
                             if e["event_type"] == "OVERLOAD_LEVEL"]
        deferred = {p: int(crons.CRON_DEFERRED.value(populator=p) - deferred0[p])
                    for p in CRON_DEFERRERS}
        log(f"cron pool round on (a): {pool} workers (AmboyConfig.pool_size_local) and "
            f"the default ladder; {n} jobs admitted, each run once and completed, "
            f"{len(shed)} shed {sorted(shed)}, no scope overlapped, launches exact, no "
            f"degradation; the ladder {' -> '.join(levels)} (the WAL flusher's peak "
            f"backlog {peaks.get('a', 0)} frames), deferred by populator {deferred}; "
            f"wall {pool_ms:.1f} ms; scheduler-tick {runs['scheduler-tick']:.1f} ms, "
            f"host-create " + (f"{runs['host-create']:.1f} ms" if "host-create" in runs
                               else "not run") + f"; {len(pool_posts)} sink deliveries, "
            f"each webhook's signature its body's HMAC")

        # ---- a failed launch inside the tick job stops the plane ----------- #
        real_launch = distro_stats._launch_fn
        distro_stats._launch_fn = lambda: (lambda *args: 719)
        raised = again = None
        recs0 = len(a.store.collection("jobs"))
        shed0 = jobs_mod.JOBS_SHED.total()
        enter("a", ("moving", now + TICK_STEP_S))
        try:
            m = a.cron_runner.tick(force=True)
            try:
                a.queue.wait_idle(timeout_s=300.0)
            except KernelError as exc:
                raised = exc
            try:
                a.cron_runner.tick(force=True)
            except KernelError as exc:
                again = exc
        finally:
            leave()
            distro_stats._launch_fn = real_launch
        if on_card:
            failed = [d for d in a.store.collection("jobs").find()
                      if d["status"] == "failed"]
            check(raised is not None and again is raised,
                  f"a failed launch in the tick job: wait_idle raised {raised!r}, the "
                  f"runner's next tick {again!r}")
            check([d["type"] for d in failed] == ["scheduler-tick"],
                  f"failed jobs {[d['type'] for d in failed]}")
            check(not a.queue._quarantined_until and "scheduler-tick" not in a.queue._failures,
                  "the tick's job type was counted toward quarantine")
            check(len(a.store.collection("jobs"))
                  == recs0 + m + jobs_mod.JOBS_SHED.total() - shed0,
                  "the stopped runner enqueued")
            check(not a.queue.put(jobs_mod.FnJob("probe", lambda s: None)),
                  "the stopped queue admitted a job")
        log(f"cron fault: a failed launch inside the tick job on (a) raised {raised!r} out "
            f"of wait_idle and again out of the runner's next tick, which enqueued "
            f"nothing; the job recorded failed, its type not counted toward quarantine")
    finally:
        leave()
        MockCloudManager.instances = real_cloud
        patches._patch_seq = real_patch_seq
        triggers._SENDERS.clear()
        triggers._SENDERS.update(real_senders)
        if sink is not None:
            sink.close()
        repotracker._SOURCES.pop(INGEST_PROJECT_ID, None)
        if server is not None:
            server.shutdown()
            server.server_close()
        for key, env in envs.items():
            env.close()
        log_mod.reset_sinks()
    for key in envs:
        probe = FileLease(os.path.join(dirs[key], "writer.lease"))
        check(probe.try_acquire(), f"({key})'s writer lease was not released")
        probe.release()
    shutil.rmtree(root, ignore_errors=True)
    log("cron: both environments closed, their leases released")
    return launches


# ---- phase 13: the entry points -------------------------------------------- #

#: the agent processes phase 13 runs against the service process, and
#: where its directory lives (inside the checkout, gitignored, removed at
#: the end of the phase)
ENTRY_AGENTS = 4
ENTRY_ROOT = os.path.join(HERE, "_smoke_entry")
#: the service's long-poll bound in phase 13's directory: an ``--once``
#: agent's last, empty pull parks this long
ENTRY_WAIT_S = 2.0
#: the seconds phase 13 gives the service to print its listening line, and
#: the agents to finish
ENTRY_BOOT_S = 240.0
ENTRY_AGENT_S = 180.0
#: the patch phase 13 posts with ``python -m evergreen_tpu_torch patch
#: --finalize`` as soon as the service listens: a small project on the
#: agents' distro (``compile`` → ``unit-tests``, ``lint``; shell commands
#: only), its project ref written by ``prepare_entry_dir``
ENTRY_PATCH_PROJECT = "entry-smoke"
ENTRY_PATCH_TASKS = ("compile", "unit-tests", "lint")
#: the seconds phase 13 waits for the service's cron plane to plan the patch
ENTRY_PLAN_S = 60.0


#: the GitHub hook phase 13 posts to the service: its secret (the
#: service's ``--github-webhook-secret``), a small project on the agents'
#: distro (``entry_hook_text``) pushed at one revision, whose file the
#: service reads from a local stand-in for the GitHub contents API (the
#: directory's ``notify`` section: egress on, its URL)
ENTRY_HOOK_SECRET = "entry-hook-secret"
ENTRY_HOOK_PROJECT = "entry-hooked"
ENTRY_HOOK_SHA = "b00c" * 10
ENTRY_HOOK_TASKS = ("hook-build", "hook-test")
#: the push phase 13 posts to the read replica (forwarded raw to the
#: service): the hooked project at another revision, the same file
ENTRY_REPLICA_SHA = "feed" * 10
#: the forwarded writes phase 13 times through the replica
ENTRY_FORWARDS = 20
#: the replica's commands phase 13 runs as processes (the others through
#: ``cli.main`` in process: ten processes cost 3-13 s on the card's host)
ENTRY_COMMAND_PROCESSES = (("host", "spawn"), ("volume", "create"))
#: the subscription phase 13's ``subscriptions`` processes list and delete
ENTRY_SUB = {"id": "entry-sub", "resource_type": "PATCH", "trigger": "outcome",
             "subscriber_type": "slack", "subscriber_target": "#entry",
             "filters": {"project": "nobody"}}

#: the naive user phase 13's ``login`` process logs in as (the
#: ``auth`` section of its directory)
ENTRY_LOGIN = ("entry-user", "entry-password")
#: phase 13's API user without the superuser scope, whose admin
#: write is refused, and the service flag the superuser's ``admin``
#: command sets through the replica: the service's tick then plans with
#: no intent hosts and no capacity page (``units/crons.py``)
ENTRY_VIEWER = ("entry-viewer", "entry-viewer-api-key")
ENTRY_FLAG = "host_allocator_disabled"
#: the test results ``unit-tests`` attaches: its results file's, then its
#: xunit file's, in the order the tests route lists them
ENTRY_RESULTS = [
    {"test_name": "test_app.py", "status": "pass", "duration_s": 0.5, "log_url": "",
     "line_num": 0},
    {"test_name": "test_edge.py", "status": "fail", "duration_s": 1.25, "log_url": "",
     "line_num": 7},
    {"test_name": "unit_ok", "status": "pass", "duration_s": 0.125, "log_url": "",
     "line_num": 0},
    {"test_name": "unit_skip", "status": "skip", "duration_s": 0.0, "log_url": "",
     "line_num": 0},
]


def entry_patch_text(distro, bucket) -> str:
    """The patch's project: ``compile`` packs a tarball, puts it in the
    bucket and attaches it by its path there; ``unit-tests`` gets it,
    unpacks it, writes a results file and an xunit file and attaches
    both; ``lint`` saves a cache and restores it after moving the cached
    directory away. The variant's ``blob_store_root`` is ``bucket``, which
    every agent shares."""
    return f"""tasks:
  - name: compile
    commands:
      - command: shell.exec
        params:
          script: |
            mkdir -p build/lib
            echo "app of ${{task_id}}" > build/app.txt
            echo "lib" > build/lib/lib.txt
      - command: archive.targz_pack
        params: {{target: app.tgz, source_dir: build, include: ["**"]}}
      - command: s3.put
        params: {{local_file: app.tgz, remote_file: builds/app.tgz}}
      - command: attach.artifacts
        params:
          files: [{{name: app.tgz, link: "${{blob_store_root}}/builds_app.tgz"}}]
  - name: unit-tests
    depends_on: [compile]
    commands:
      - command: s3.get
        params: {{remote_file: builds/app.tgz, local_file: got/app.tgz}}
      - command: archive.targz_extract
        params: {{path: got/app.tgz, destination: unpacked}}
      - command: shell.exec
        params:
          script: |
            test -s unpacked/app.txt && test -s unpacked/lib/lib.txt
            cat > results.json <<'END'
            {{"results": [{{"test_file": "test_app.py", "status": "pass", "elapsed": 0.5}},
              {{"test_file": "test_edge.py", "status": "fail", "elapsed": 1.25, "line_num": 7}}]}}
            END
            cat > junit.xml <<'END'
            <testsuite name="app"><testcase name="unit_ok" time="0.125"/>
            <testcase name="unit_skip"><skipped/></testcase></testsuite>
            END
      - command: attach.results
        params: {{file_location: results.json}}
      - command: attach.xunit_results
        params: {{file: junit.xml}}
  - name: lint
    commands:
      - command: shell.exec
        params:
          script: |
            mkdir -p deps && echo "dep of ${{task_id}}" > deps/dep.txt
      - command: cache.save
        params: {{key: "lint-${{task_id}}", paths: [deps]}}
      - command: shell.exec
        params: {{script: "mv deps deps-saved"}}
      - command: cache.restore
        params: {{key: "lint-${{task_id}}"}}
      - command: shell.exec
        params: {{script: "cmp deps/dep.txt deps-saved/dep.txt"}}
buildvariants:
  - name: entry
    run_on: [{distro}]
    expansions: {{blob_store_root: "{bucket}"}}
    tasks: [compile, unit-tests, lint]
"""


def entry_hook_text(distro) -> str:
    """The pushed project: two shell tasks on ``distro``, the second
    after the first."""
    return f"""tasks:
  - name: hook-build
    commands:
      - command: shell.exec
        params: {{script: "echo built the pushed revision"}}
  - name: hook-test
    depends_on: [hook-build]
    commands:
      - command: shell.exec
        params: {{script: "echo tested the pushed revision"}}
buildvariants:
  - name: hooked
    run_on: [{distro}]
    tasks: [hook-build, hook-test]
"""


def entry_push_payload(sha=ENTRY_HOOK_SHA) -> dict:
    """A GitHub push of ``sha`` to the hooked project's branch."""
    return {"ref": "refs/heads/main",
            "repository": {"name": ENTRY_HOOK_PROJECT, "owner": {"login": "smoke"}},
            "commits": [{"id": sha, "message": "the pushed revision",
                         "author": {"name": "smoke"}}]}


def hook_contents(sha) -> str:
    """The contents API path the service reads the pushed file from."""
    return f"/repos/smoke/{ENTRY_HOOK_PROJECT}/contents/evergreen.yml?ref={sha}"


def eventually(read, want, label, timeout_s=15.0):
    """``read()`` again until ``want`` holds of its result, for up to
    ``timeout_s``: a follower read shows a write made through the primary
    once the writer's WAL holds it and the follower has polled past it.
    The writer's flusher may queue a per-op line behind a tick's frames,
    and a follower's staleness counts from its last poll that reached
    the end of the WAL, not from the write, so no reading of it proves a
    given write is there. Returns the last result."""
    t0 = time.perf_counter()
    while True:
        got = read()
        if want(got):
            return got
        check(time.perf_counter() - t0 < timeout_s,
              f"entry: {label} within {timeout_s} s: {str(got)[:400]}")
        time.sleep(0.05)


def post_github_hook(base, event, payload, secret) -> tuple:
    """``POST /hooks/github`` with the body's ``X-Hub-Signature-256``
    under ``secret``: (status, answer)."""
    import hashlib
    import hmac
    import urllib.error
    import urllib.request

    raw = json.dumps(payload).encode()
    sig = "sha256=" + hmac.new(secret.encode(), raw, hashlib.sha256).hexdigest()
    req = urllib.request.Request(base + "/hooks/github", data=raw, method="POST", headers={
        "Content-Type": "application/json", "X-GitHub-Event": event,
        "X-Hub-Signature-256": sig})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def prepare_entry_dir(seed_dir, data_dir, sink_url="", n_agents=ENTRY_AGENTS) -> list:
    """Phase 12's seeded directory written anew to ``data_dir``, in one
    group frame at epoch 0 (no lease), ready for a service on the wall
    clock: the tasks' and hosts' times moved from ``benchgen.NOW`` to now
    (a task activated in the benchgen's 2025 would be unscheduled as
    underwater), the running hosts static machines (the mock cloud's
    instance table lives in one process: the service's host monitors
    would find this one's mock instances missing and terminate the
    hosts), the long-poll bound ``ENTRY_WAIT_S``, and secrets for the
    first ``n_agents`` free running hosts in id order (the service's
    migration mints the others'); the project ref of
    ``ENTRY_PATCH_PROJECT``, and beside the directory its patch's project
    file on the first agent's distro with the agents' shared bucket root,
    and the naive user ``ENTRY_LOGIN`` in the ``auth`` section; the
    hooked project's ref (``smoke/entry-hooked``, branch ``main``) and,
    with ``sink_url``, the ``notify`` section's egress on with that URL
    as the GitHub API's. Returns those hosts' (id, secret) pairs, the
    file's path, the bucket's and the first agent's distro."""
    from evergreen_tpu_torch.ingestion.repotracker import ProjectRef
    from evergreen_tpu_torch.models.user import User
    from evergreen_tpu_torch.settings import AuthConfig, NotifyConfig, ReadPathConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.utils.benchgen import NOW

    offset = time.time() - NOW
    src = DurableStore(seed_dir)  # read only: its journal handle closed below
    docs = {n: [dict(d) for d in src.collection(n).find()] for n in sorted(src._collections)}
    src._journal.close()
    for name in ("tasks", "hosts"):
        for doc in docs.get(name, ()):
            for k, v in doc.items():
                if (isinstance(v, float) and v > 1e9
                        and (k.endswith(("_time", "_at")) or k == "last_heartbeat")):
                    doc[k] = v + offset
            if name == "hosts" and doc["status"] == "running":
                doc["provider"] = "static"
    agents = [(hid, f"entry-secret-{hid}") for hid in sorted(
        d["_id"] for d in docs["hosts"]
        if d["status"] == "running" and not d["running_task"])[:n_agents]]
    secrets = dict(agents)
    for doc in docs["hosts"]:
        if doc["_id"] in secrets:
            doc["secret"] = secrets[doc["_id"]]
    distro = next(d["distro_id"] for d in docs["hosts"] if d["_id"] == agents[0][0])
    patch_file = os.path.join(os.path.dirname(data_dir), "entry-patch.yml")
    bucket = os.path.join(os.path.dirname(data_dir), "entry-bucket")
    with open(patch_file, "w") as fh:
        fh.write(entry_patch_text(distro, bucket))
    dst = DurableStore(data_dir)
    dst.begin_tick()
    for name, found in docs.items():
        dst.collection(name).insert_many(found)
    dst.collection("project_refs").insert(ProjectRef(id=ENTRY_PATCH_PROJECT).to_doc())
    dst.collection("project_refs").insert(ProjectRef(
        id=ENTRY_HOOK_PROJECT, owner="smoke", repo=ENTRY_HOOK_PROJECT, branch="main").to_doc())
    if sink_url:
        NotifyConfig(egress_enabled=True, github_api_url=sink_url).set(dst)
    ReadPathConfig(longpoll_max_wait_s=ENTRY_WAIT_S).set(dst)
    AuthConfig(preferred_type="naive", naive_users=[
        {"username": ENTRY_LOGIN[0], "password": ENTRY_LOGIN[1]}]).set(dst)
    dst.collection("users").insert(User(id=ENTRY_VIEWER[0], api_key=ENTRY_VIEWER[1]).to_doc())
    dst.end_tick()
    dst.close()
    return {"agents": agents, "patch_file": patch_file, "bucket": bucket, "distro": distro}


class EntryService:
    """Phase 13's ``python -m evergreen_tpu_torch service`` process. It
    starts (``start``, from phase 12 once its directory is seeded) on
    phase 12's seeded documents (``prepare_entry_dir``), so that its boot
    (the card's probe, replay, migrations, recovery) and first cron ticks
    overlap phase 12; ``entry_phase`` is phase 13 proper."""

    def __init__(self, root, device_args=()):
        self.root = root
        self.device_args = list(device_args)
        #: the service records its plane here (``--capture-trace``)
        self.capture = os.path.join(root, "service-trace.jsonl")
        self.proc = None
        self.lines = []
        self.listening = threading.Event()
        self.error = None
        self.patch_thread = self.patch_run = None
        self.hook_thread = self.hook_run = None
        self.sink = None
        #: the read replica's process, started once the service listens
        self.replica = None
        self.replica_lines = []
        self.replica_listening = threading.Event()
        self.replica_error = None
        self.replica_hook_run = None

    def start(self, seed_dir) -> None:
        self.t0 = time.perf_counter()
        # the GitHub contents API the service reads the pushed file from
        self.sink = LocalSink()
        self.thread = threading.Thread(target=self._run, args=(seed_dir,), daemon=True)
        self.thread.start()

    def _run(self, seed_dir) -> None:
        import shutil

        try:
            self.data_dir = os.path.join(self.root, "entry")
            shutil.rmtree(self.data_dir, ignore_errors=True)
            # the directory's preparation runs in its own interpreter, off
            # this process's interpreter lock (phase 12 runs meanwhile)
            prep = subprocess.run(
                [sys.executable, "-c", "import json, sys; import chip_smoke as cs; "
                 "print(json.dumps(cs.prepare_entry_dir(*sys.argv[1:4])))",
                 seed_dir, self.data_dir, self.sink.url],
                capture_output=True, text=True, cwd=HERE, timeout=300,
                env=dict(os.environ, PYTHONPATH=HERE))
            if prep.returncode != 0:
                raise RuntimeError(f"prepare_entry_dir: {prep.stderr[-2000:]}")
            prepared = json.loads(prep.stdout.strip().splitlines()[-1])
            self.agents, self.patch_file = prepared["agents"], prepared["patch_file"]
            self.bucket, self.distro = prepared["bucket"], prepared["distro"]
            for sha in (ENTRY_HOOK_SHA, ENTRY_REPLICA_SHA):
                self.sink.files[hook_contents(sha)] = entry_hook_text(prepared["distro"])
            self.prep_s = time.perf_counter() - self.t0
            self.stderr = open(os.path.join(self.root, "entry-service.err"), "w")
            self.t_spawn = time.perf_counter()
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "evergreen_tpu_torch", "service", "--data-dir",
                 self.data_dir, "--port", "0", "--workers", "1", "--require-auth",
                 "--github-webhook-secret", ENTRY_HOOK_SECRET,
                 "--capture-trace", self.capture, *self.device_args],
                stdout=subprocess.PIPE, stderr=self.stderr, text=True, cwd=HERE,
                env=dict(os.environ, PYTHONPATH=HERE))
            for line in self.proc.stdout:
                self.lines.append((time.perf_counter(), line.rstrip("\n")))
                if "listening on" in line:
                    self.base = "http://" + line.split("listening on ")[1].split()[0]
                    self.patch_thread = threading.Thread(target=self._patch, daemon=True)
                    self.patch_thread.start()
                    self.hook_thread = threading.Thread(target=self._hook, daemon=True)
                    self.hook_thread.start()
                    self.replica_thread = threading.Thread(target=self._replica, daemon=True)
                    self.replica_thread.start()
                    self.listening.set()
        except Exception as exc:  # noqa: BLE001 — raised in finish()
            self.error = exc
        finally:
            self.listening.set()

    def _replica(self) -> None:
        """``python -X importtime -m evergreen_tpu_torch service
        --replica-of <the service's URL> --data-dir D --port 0
        --require-auth`` beside the service, on its directory; keeps its
        lines and URL (or the exception)."""
        try:
            self.replica_err = open(os.path.join(self.root, "entry-replica.err"), "w")
            self.t_replica = time.perf_counter()
            self.replica = subprocess.Popen(
                [sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch", "service",
                 "--replica-of", self.base, "--data-dir", self.data_dir, "--port", "0",
                 "--require-auth"],
                stdout=subprocess.PIPE, stderr=self.replica_err, text=True, cwd=HERE,
                env=dict(os.environ, PYTHONPATH=HERE))
            for line in self.replica.stdout:
                self.replica_lines.append((time.perf_counter(), line.rstrip("\n")))
                if "listening on" in line:
                    self.replica_base = "http://" + line.split("listening on ")[1].split()[0]
                    self.replica_hook_run = self._replica_hook()
                    self.replica_listening.set()
        except Exception as exc:  # noqa: BLE001 — raised in entry_replica
            self.replica_error = exc
        finally:
            self.replica_listening.set()

    def _replica_hook(self):
        """The push of ``ENTRY_REPLICA_SHA`` to the replica as soon as it
        listens (so the service's ticks plan it during phase 12), signed
        with another secret, then with the service's; keeps both
        answers, the signed one's ms and the replica's read of the
        version right after it (or the exception)."""
        try:
            payload = entry_push_payload(ENTRY_REPLICA_SHA)
            wrong = post_github_hook(self.replica_base, "push", payload, "not-the-secret")
            t0 = time.perf_counter()
            signed = post_github_hook(self.replica_base, "push", payload, ENTRY_HOOK_SECRET)
            hook_ms = (time.perf_counter() - t0) * 1e3
            vid = (signed[1].get("versions") or [""])[0]
            back = http_json(self.replica_base, "GET", f"/rest/v2/versions/{vid}",
                             headers=api_headers())
            return wrong, signed, hook_ms, back
        except Exception as exc:  # noqa: BLE001 — raised in entry_replica
            return exc

    def _patch(self) -> None:
        """``python -X importtime -m evergreen_tpu_torch patch --finalize``
        with the API user's key against the listening service; keeps the
        completed process and its wall seconds (or the exception)."""
        t0 = time.perf_counter()
        try:
            done = subprocess.run(
                [sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch", "patch",
                 "--project", ENTRY_PATCH_PROJECT, "--config", self.patch_file, "--finalize",
                 "--description", "phase 13's patch", "--author", "smoke",
                 "--api-server", self.base, "--api-user", INGEST_USER[0],
                 "--api-key", INGEST_USER[1]],
                capture_output=True, text=True, cwd=HERE, timeout=120,
                env=dict(os.environ, PYTHONPATH=HERE))
            self.patch_run = (done, time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — raised in entry_phase
            self.patch_run = exc

    def _hook(self) -> None:
        """The push of ``ENTRY_HOOK_SHA`` to the listening service, signed
        with another secret, then with its own; keeps both answers and
        the signed one's wall seconds (or the exception)."""
        try:
            wrong = post_github_hook(self.base, "push", entry_push_payload(), "not-the-secret")
            t0 = time.perf_counter()
            signed = post_github_hook(self.base, "push", entry_push_payload(),
                                      ENTRY_HOOK_SECRET)
            self.hook_run = (wrong, signed, time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — raised in entry_phase
            self.hook_run = exc

    def line(self, prefix):
        return next((x for _, x in self.lines if x.startswith(prefix)), None)

    def stop(self) -> None:
        for proc in (self.replica, self.proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if self.sink is not None:
            self.sink.close()
            self.sink = None


def check_no_torch(err, who) -> None:
    """The ``-X importtime`` lines of a process's stderr name neither
    ``torch`` nor the card's probe."""
    mods = {x.rsplit("|", 1)[-1].strip() for x in err.splitlines()
            if x.startswith("import time:")}
    check(mods and not any(m == "torch" or m.startswith("torch.") for m in mods),
          f"entry: {who} imported torch (or printed no import times)")
    check("evergreen_tpu_torch.utils.torchenv" not in mods,
          f"entry: {who} imported the probe")


def entry_patch_planned(entry, base) -> tuple:
    """The ``patch --finalize`` process ``EntryService`` ran once the
    service listened: exit 0, no ``torch`` imported, the patch finalized;
    then its tasks' documents (``GET /rest/v2/tasks/{id}``) until the
    service's own cron plane planned every one (``scheduled_time``).
    Returns (the task ids, the patch id)."""
    from evergreen_tpu_torch.ingestion.project import task_id_for

    entry.patch_thread.join(timeout=150)
    got = entry.patch_run
    if isinstance(got, Exception):
        raise got
    check(got is not None, "entry: the patch process did not finish")
    done, wall_s = got
    check(done.returncode == 0, f"entry: patch exited {done.returncode}: {done.stderr[-500:]}")
    check_no_torch(done.stderr, "the patch process")
    pdoc = json.loads(done.stdout)
    check(pdoc.get("status") == "started" and pdoc.get("version"),
          f"entry: the patch answered {str(pdoc)[:300]}")
    ids = [task_id_for(ENTRY_PATCH_PROJECT, "entry", n, pdoc["githash"], pdoc["patch_number"])
           for n in ENTRY_PATCH_TASKS]
    # follower reads: a 404 until the follower holds the patch's tasks
    t0 = time.perf_counter()
    eventually(lambda: [http_json(base, "GET", f"/rest/v2/tasks/{t}", headers=api_headers())
                        for t in ids],
               lambda docs: all(st == 200 and d["scheduled_time"] > 0 for st, d in docs),
               "the service's cron plane planned the patch's tasks", ENTRY_PLAN_S)
    log(f"entry: python -m evergreen_tpu_torch patch --finalize (exit 0 in {wall_s:.1f} s, "
        f"no torch imported) made {pdoc['_id']} and version {pdoc['version']}; the service's "
        f"cron plane had planned its {len(ids)} tasks "
        f"{time.perf_counter() - t0:.1f} s after phase 13 asked")
    return ids, pdoc["_id"]


def entry_hook_planned(entry, base) -> tuple:
    """The GitHub push ``EntryService`` posted once the service listened:
    the wrongly signed one answered 401 and made nothing; the signed one
    200 with one version, whose project file the service read from the
    contents stand-in; then that version's tasks (``GET
    /rest/v2/versions/{id}/tasks``) until the service's cron plane
    planned every one on the card. Returns (the version, its task ids)."""
    entry.hook_thread.join(timeout=150)
    got = entry.hook_run
    if isinstance(got, Exception):
        raise got
    check(got is not None, "entry: the push hook did not finish")
    wrong, signed, wall_s = got
    check(wrong == (401, {"error": "invalid webhook signature"}),
          f"entry: the wrongly signed push answered {wrong}")
    check(signed[0] == 200 and len(signed[1].get("versions", [])) == 1,
          f"entry: the signed push answered {signed}")
    check(entry.sink.gets.count(hook_contents(ENTRY_HOOK_SHA)) == 1,
          f"entry: the service read the pushed file {entry.sink.gets}")
    vid = signed[1]["versions"][0]
    t0 = time.perf_counter()
    st, tasks = eventually(
        lambda: http_json(base, "GET", f"/rest/v2/versions/{vid}/tasks",
                          headers=api_headers()),
        lambda got: got[0] == 200 and sorted(t["display_name"] for t in got[1])
        == sorted(ENTRY_HOOK_TASKS) and all(t["scheduled_time"] > 0 for t in got[1]),
        "the service's cron plane planned the pushed version's tasks", ENTRY_PLAN_S)
    log(f"entry: a push signed with another secret answered 401; the signed push of "
        f"{ENTRY_HOOK_SHA[:8]} to {ENTRY_HOOK_PROJECT} answered 200 in {wall_s * 1e3:.1f} ms "
        f"with version {vid} (its file read from the contents stand-in); the service's "
        f"cron plane had planned its {len(tasks)} tasks "
        f"{time.perf_counter() - t0:.1f} s after phase 13 asked")
    return vid, [t["_id"] for t in tasks]


def entry_operator(base) -> dict:
    """The operator's side of the service process: a subscription made
    over REST, then ``python -X importtime -m evergreen_tpu_torch
    subscriptions list`` / ``delete`` / ``list`` processes with the API
    user's key (no ``torch`` imported), the first listing it, the last
    not; ``GET /metrics`` parses, with the service's ticks counted, and
    ``GET /healthz/ready`` answers ready. Returns the processes' wall s
    and the reads' ms."""
    st, out = http_json(base, "POST", "/rest/v2/subscriptions", ENTRY_SUB,
                        headers=api_headers())
    check(st == 201 and out["_id"] == ENTRY_SUB["id"], f"entry: subscription {st} {out}")

    def cli(*argv):
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch", "subscriptions",
             *argv, "--api-server", base, "--api-user", INGEST_USER[0],
             "--api-key", INGEST_USER[1]], capture_output=True, text=True, cwd=HERE,
            timeout=120, env=dict(os.environ, PYTHONPATH=HERE))
        check(done.returncode == 0, f"entry: subscriptions {argv} exited {done.returncode}: "
              f"{done.stdout[-300:]} {done.stderr[-300:]}")
        check_no_torch(done.stderr, f"the subscriptions {argv[0]} process")
        return done.stdout, time.perf_counter() - t0

    row = (f"{ENTRY_SUB['id']}\t{ENTRY_SUB['resource_type']}\t{ENTRY_SUB['trigger']}"
           f"\t{ENTRY_SUB['subscriber_type']}\t{ENTRY_SUB['subscriber_target']}")
    # the listings are follower reads: each command runs once the route
    # shows the change it follows
    subs = "/rest/v2/subscriptions"
    eventually(lambda: http_json(base, "GET", subs, headers=api_headers())[1],
               lambda got: ENTRY_SUB["id"] in [x["_id"] for x in got],
               "the subscription listed")
    listed, list_s = cli("list")
    deleted, delete_s = cli("delete", "--sub-id", ENTRY_SUB["id"])
    eventually(lambda: http_json(base, "GET", subs, headers=api_headers())[1],
               lambda got: ENTRY_SUB["id"] not in [x["_id"] for x in got],
               "the subscription gone")
    after, _ = cli("list")
    check(row in listed.splitlines() and json.loads(deleted) == {"ok": True}
          and row not in after.splitlines(),
          f"entry: subscriptions listed {listed!r}, deleted {deleted!r}, then {after!r}")
    t0 = time.perf_counter()
    st, ctype, text = http_text(base, "/metrics")
    metrics_ms = (time.perf_counter() - t0) * 1e3
    check(st == 200 and ctype == "text/plain; version=0.0.4; charset=utf-8",
          f"entry: /metrics answered {st} {ctype}")
    samples = parse_exposition(text)
    ticks = series_sum(samples, "scheduler_ticks_total")
    check(ticks >= 1, "entry: the service's /metrics counts no tick")
    t0 = time.perf_counter()
    st, ready = http_json(base, "GET", "/healthz/ready")
    ready_ms = (time.perf_counter() - t0) * 1e3
    lag = ready.pop("follower_staleness_ms", None)
    check((st, ready) == (200, {"ready": True, "role": "primary"})
          and lag is not None and lag < 2000.0,
          f"entry: /healthz/ready answered {st} {ready}, follower staleness {lag}")
    log(f"entry: a subscription made over REST; subscriptions list / delete / list "
        f"(processes, no torch imported; {list_s:.1f} s and {delete_s:.1f} s) listed it, "
        f"deleted it, and listed it no more; /metrics ({len(text)} bytes, {len(samples)} "
        f"samples, {ticks:.0f} ticks counted, api_requests_total "
        f"{series_sum(samples, 'api_requests_total'):.0f}) in {metrics_ms:.1f} ms; "
        f"/healthz/ready ready, primary, its follower {lag} ms stale, in {ready_ms:.1f} ms")
    return {"list_s": list_s, "delete_s": delete_s, "metrics_ms": metrics_ms,
            "ready_ms": ready_ms}


def entry_patch_done(base, ids, patch_id) -> None:
    """After the agents, once the service's follower holds their ends:
    every task of the patch ``success`` (``GET /rest/v2/tasks/{id}``),
    the patch started with its version (``GET
    /rest/v2/patches/{id}``)."""
    eventually(lambda: [http_json(base, "GET", f"/rest/v2/tasks/{t}", headers=api_headers())
                        for t in ids],
               lambda docs: all(st == 200 and d["status"] == "success" for st, d in docs),
               "the patch's tasks success")
    st, p = http_json(base, "GET", f"/rest/v2/patches/{patch_id}", headers=api_headers())
    check(st == 200 and p["status"] == "started" and p["activated"] and p["version"],
          f"entry: the patch {st} {str(p)[:300]}")
    log(f"entry: the agents ran the patch's {len(ids)} tasks, each success; patch "
        f"{patch_id} started, version {p['version']}")


def entry_user_loop(entry, base, ids) -> dict:
    """A user's loop over HTTP against the service, after the agents: a
    ``python -X importtime -m evergreen_tpu_torch login`` process prints
    a session token (no ``torch`` imported); with ``Authorization: Bearer
    <token>`` and no API key, ``unit-tests``' ``tests`` route lists the
    results it attached in the order it attached them, ``compile``'s
    ``artifacts`` route lists its bucket key and its path, and
    ``/rest/v2/status`` answers 200; a ``fetch --artifacts`` process
    copies the file at that path (the bucket key skipped as
    unreachable); ``POST /logout`` makes the token 401. Returns the
    login's and the fetch's wall s and each read's ms."""
    import shutil

    compile_id, tests_id, _ = ids

    def cli(*argv):
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch",
                               *argv, "--api-server", base], capture_output=True, text=True,
                              cwd=HERE, timeout=120, env=dict(os.environ, PYTHONPATH=HERE))
        check(done.returncode == 0, f"entry: {argv[0]} exited {done.returncode}: "
              f"{done.stdout[-300:]} {done.stderr[-500:]}")
        check_no_torch(done.stderr, f"the {argv[0]} process")
        return done, time.perf_counter() - t0

    done, login_s = cli("login", "--username", ENTRY_LOGIN[0], "--password", ENTRY_LOGIN[1])
    token = done.stdout.strip()
    check(len(token) == 48, f"entry: login printed {done.stdout[-200:]!r}")
    bearer = {"Authorization": f"Bearer {token}"}
    reads = {}

    def read(path, want=200):
        t0 = time.perf_counter()
        st, out = http_json(base, "GET", path, headers=bearer)
        reads[path] = (time.perf_counter() - t0) * 1e3
        check(st == want, f"entry: GET {path} with the session token answered {st} {out}")
        return out

    check(read(f"/rest/v2/tasks/{tests_id}/tests") == ENTRY_RESULTS,
          f"entry: unit-tests' results {read(f'/rest/v2/tasks/{tests_id}/tests')}")
    link = os.path.join(entry.bucket, "builds_app.tgz")
    arts = read(f"/rest/v2/tasks/{compile_id}/artifacts")
    check([(a["name"], a["link"]) for a in arts]
          == [("builds/app.tgz", "builds/app.tgz"), ("app.tgz", link)],
          f"entry: compile's artifacts {arts}")
    status = read("/rest/v2/status")
    check(status["tasks"] > 0 and status["hosts"] > 0, f"entry: status {status}")
    dest = os.path.join(entry.root, "entry-fetch")
    done, fetch_s = cli("fetch", "--task", compile_id, "--artifacts", "--dir", dest,
                        "--api-user", INGEST_USER[0], "--api-key", INGEST_USER[1])
    got = os.path.join(dest, f"compile-{compile_id}", "app.tgz")
    with open(got, "rb") as fh, open(link, "rb") as want:
        check(fh.read() == want.read(), "entry: the fetched app.tgz is not the bucket's")
    check("1 artifact(s)" in done.stdout and "skip builds/app.tgz: unreachable link"
          in done.stderr, f"entry: fetch printed {done.stdout[-300:]} {done.stderr[-300:]}")
    shutil.rmtree(dest, ignore_errors=True)
    st, out = http_json(base, "POST", "/logout", {}, headers=bearer)
    check((st, out) == (200, {"ok": True}), f"entry: logout answered {st} {out}")
    read("/rest/v2/status", want=401)
    log(f"entry: a user's loop over HTTP: login (a process, exit 0 in {login_s:.1f} s, no "
        f"torch imported) printed a session token; with it alone, unit-tests' tests route "
        f"listed its {len(ENTRY_RESULTS)} attached results in order, compile's artifacts "
        f"its bucket key and path, the status answered 200 (ms "
        + ", ".join(f"{p.rsplit('/', 1)[-1]} {ms:.1f}" for p, ms in reads.items())
        + f"); fetch --artifacts (a process, {fetch_s:.1f} s) copied app.tgz and skipped "
        f"the bucket key; logout made the token 401")
    return {"login_s": login_s, "fetch_s": fetch_s, "read_ms": reads}


def entry_replica(entry, base) -> dict:
    """Phase 13's read replica (``EntryService._replica``: ``service
    --replica-of`` on the service's directory, booted beside it during
    phase 12). Holds: ``/healthz/ready`` on the replica reports role
    ``replica``, ready, under its bound; the agents' distro's queue route
    from the replica equals the service's; a push signed with another
    secret and posted to the replica answers 401, the signed one is
    forwarded raw and makes one version, which the replica reads back at
    once and the card's tick plans and queues (posted from
    ``EntryService._replica_hook`` as the replica listened, during phase
    12; the agents may have run its tasks since); the ``host`` and
    ``volume`` commands aimed at the
    replica with the API user's key spawn, extend, stop and start a host,
    make, attach, detach and delete a volume and terminate the host, each
    write forwarded, read back from the replica at once and shown by the
    service once its follower holds it (two of the commands run as
    processes, ``ENTRY_COMMAND_PROCESSES``); a write marked
    ``X-Evg-Forwarded`` is refused (503), not forwarded again. Then
    SIGTERM: exit 0, and its ``-X importtime`` lines name neither
    ``torch`` nor the probe (no CUDA context, no kernel). Returns its
    boot s and the forwarded writes' ms."""
    import contextlib
    import io

    from evergreen_tpu_torch import cli as cli_mod

    check(entry.replica_listening.wait(ENTRY_BOOT_S), "entry: the replica printed no "
          "listening line")
    if entry.replica_error is not None:
        raise entry.replica_error
    listen = next(((t, x) for t, x in entry.replica_lines
                   if x.startswith("evergreen_tpu_torch replica listening on")), None)
    check(listen is not None, "entry: the replica exited before it listened: "
          + " | ".join(x for _, x in entry.replica_lines[-5:]))
    rbase, boot_s = entry.replica_base, listen[0] - entry.t_replica
    boot = next(x for _, x in entry.replica_lines if x.startswith("boot ms: "))
    hdr = api_headers()
    t0 = time.perf_counter()
    st, ready = http_json(rbase, "GET", "/healthz/ready")
    ready_ms = (time.perf_counter() - t0) * 1e3
    check(st == 200 and ready["role"] == "replica" and ready["ready"] is True
          and ready["staleness_ms"] < ready["staleness_bound_ms"],
          f"entry: the replica's /healthz/ready answered {st} {ready}")
    # the push through the replica, posted as soon as it listened:
    # forwarded as its raw bytes
    if isinstance(entry.replica_hook_run, Exception):
        raise entry.replica_hook_run
    wrong, signed, hook_ms, (st, vdoc) = entry.replica_hook_run
    check(wrong == (401, {"error": "invalid webhook signature"}),
          f"entry: a wrongly signed push to the replica answered {wrong}")
    check(signed[0] == 200 and len(signed[1].get("versions", [])) == 1
          and entry.sink.gets.count(hook_contents(ENTRY_REPLICA_SHA)) == 1,
          f"entry: the signed push to the replica answered {signed}")
    vid = signed[1]["versions"][0]
    check(st == 200 and vdoc.get("revision") == ENTRY_REPLICA_SHA,
          f"entry: the replica read the forwarded push's version back as {st} {vdoc}")
    # the queue route from the replica against the service's (its
    # follower's), read between two of the replica's that agree: both
    # tails reach the tick's last queue document within a poll or two
    qpath = f"/rest/v2/distros/{entry.distro}/queue"
    first, primary, again = eventually(
        lambda: [http_json(b, "GET", qpath, headers=hdr) for b in (rbase, base, rbase)],
        lambda got: got[0][0] == 200 and got[0] == got[1] == got[2],
        f"the queue route of {entry.distro} equal on the replica and the service")

    def cli(*argv, process=False):
        """A ``host`` or ``volume`` command through the replica with the API
        user's key: a ``-X importtime`` process (no ``torch`` imported),
        or ``cli.main`` in this process (``ENTRY_COMMAND_PROCESSES``)."""
        creds = ["--api-server", rbase, "--api-user", INGEST_USER[0], "--api-key",
                 INGEST_USER[1]]
        t0 = time.perf_counter()
        if process:
            done = subprocess.run(
                [sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch", *argv,
                 *creds], capture_output=True, text=True, cwd=HERE, timeout=120,
                env=dict(os.environ, PYTHONPATH=HERE))
            check_no_torch(done.stderr, f"the {argv[0]} {argv[1]} process")
            rc, text = done.returncode, done.stdout
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_mod.main([*argv, *creds])
            text = buf.getvalue()
        check(rc == 0, f"entry: {argv[:2]} through the replica exited {rc}: {text[-300:]}")
        return json.loads(text), time.perf_counter() - t0

    walls = []

    def step(argv, path, want, want_primary=None):
        """One command through the replica; then ``path`` (or
        ``path(output)``) read from the replica at once, and from the
        service once its follower holds the write."""
        out, wall = cli(*argv, process=argv[:2] in ENTRY_COMMAND_PROCESSES)
        walls.append((wall, argv[:2] in ENTRY_COMMAND_PROCESSES))
        path = path(out) if callable(path) else path
        got = http_json(rbase, "GET", path, headers=hdr)
        check(got[0] == 200 and want(got[1]), f"entry: after {argv[:2]} the replica read "
              f"{path} as {str(got)[:300]}")
        eventually(lambda: http_json(base, "GET", path, headers=hdr),
                   lambda shown: shown[0] == 200 and (want_primary or want)(shown[1]),
                   f"after {argv[:2]} the service reads {path}")
        return out

    user = INGEST_USER[0]
    h = step(("host", "spawn", "--distro", entry.distro, "--user", user),
             lambda out: f"/rest/v2/hosts/{out['_id']}",
             lambda d: d["started_by"] == user and d["user_host"])["_id"]
    hpath = f"/rest/v2/hosts/{h}"
    exp = step(("host", "extend", "--id", h, "--hours", "6"), hpath,
               lambda d: d["expiration_time"] > d["creation_time"] + 24 * 3600.0)
    exp = exp["expiration_time"]
    check(http_json(base, "GET", hpath, headers=hdr)[1]["expiration_time"] == exp,
          "entry: the service's host does not carry the extension")
    step(("host", "stop", "--id", h, "--user", user), hpath,
         lambda d: d["status"] == "stopped")
    # a running spawn host with no instance in the service's mock cloud:
    # the service's host monitor may end it before its follower is read
    step(("host", "start", "--id", h, "--user", user), hpath,
         lambda d: d["status"] == "running",
         lambda d: d["status"] in ("running", "terminated"))
    vpath = f"/rest/v2/volumes?user={user}"
    made = {}

    def vol(vs):
        """The volume's document in a list read, or {} where the list
        does not hold it: the service's follower may not have polled past
        the write yet, so a read there waits for it."""
        return next((x for x in vs if x["_id"] == made["_id"]), {})

    v = step(("volume", "create", "--size-gb", "40", "--user", user),
             lambda out: made.update(out) or vpath, lambda vs: bool(vol(vs)))["_id"]
    step(("volume", "attach", "--id", v, "--host", h), vpath,
         lambda vs: vol(vs).get("host_id") == h)
    step(("volume", "detach", "--id", v), vpath, lambda vs: vol(vs).get("host_id") == "")
    step(("volume", "delete", "--id", v), vpath, lambda vs: not vol(vs))
    # the forwarded writes, timed: extensions of the host through the replica
    fwd_ms = []
    for _ in range(ENTRY_FORWARDS):
        t0 = time.perf_counter()
        st, out = http_json(rbase, "POST", f"{hpath}/extend_expiration", {"hours": 1},
                            headers=hdr)
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        check(st == 200 and out["expiration_time"] > exp, f"entry: a forwarded extension "
              f"answered {st} {out}")
        exp = out["expiration_time"]
    check(http_json(rbase, "GET", hpath, headers=hdr)[1]["expiration_time"] == exp,
          "entry: the replica does not read its last forwarded extension back")
    # a write marked as forwarded already runs on the replica: refused
    st, out = http_json(rbase, "POST", "/rest/v2/volumes", {"size_gb": 7, "user": user},
                        headers=dict(hdr, **{"X-Evg-Forwarded": "1"}))
    check((st, out) == (503, {"error": "this server is a read-only replica",
                              "primary": base}),
          f"entry: a write marked X-Evg-Forwarded answered {st} {out}")
    step(("host", "terminate", "--id", h, "--user", user), hpath,
         lambda d: d["status"] == "terminated")
    # the service's follower holds the later termination, so it would hold
    # the refused write too had it reached the service
    check(not [x for x in http_json(base, "GET", vpath, headers=hdr)[1]
               if x["size_gb"] == 7], "entry: the refused write reached the service")
    # the forwarded push: planned by the card's tick, then queued (or
    # already handed to the agents, which pull until the queue is empty)
    t0 = time.perf_counter()
    st, tasks = eventually(
        lambda: http_json(rbase, "GET", f"/rest/v2/versions/{vid}/tasks", headers=hdr),
        lambda got: got[0] == 200 and sorted(t["display_name"] for t in got[1])
        == sorted(ENTRY_HOOK_TASKS) and all(t["scheduled_time"] > 0 for t in got[1]),
        "the service planned a tick of the forwarded push", ENTRY_PLAN_S)
    plan_s = time.perf_counter() - t0
    st, queue = http_json(rbase, "GET", qpath, headers=hdr)
    queued = {i["id"] for i in queue.get("queue", [])}
    check(st == 200 and all(t["_id"] in queued or t["status"] != "undispatched"
                            for t in tasks),
          f"entry: the forwarded push's tasks {[(t['_id'], t['status']) for t in tasks]} "
          f"are neither in {entry.distro}'s queue nor handed out")
    t0 = time.perf_counter()
    entry.replica.send_signal(signal.SIGTERM)
    rc = entry.replica.wait(timeout=60)
    entry.replica_thread.join(timeout=30)
    entry.replica_err.close()
    with open(entry.replica_err.name) as fh:
        err = fh.read()
    check(rc == 0 and any(x == "replica drained" for _, x in entry.replica_lines),
          f"entry: the replica exited {rc} on SIGTERM: {err[-500:]}")
    check_no_torch(err, "the replica")
    fwd = sorted(fwd_ms)
    procs = [w for w, proc in walls if proc]
    inproc = [w for w, proc in walls if not proc]
    log(f"entry: the read replica (service --replica-of, its own process on the service's "
        f"directory) listened {boot_s:.1f} s after its spawn ({boot}); /healthz/ready "
        f"{ready['role']}, ready, {ready['staleness_ms']} ms stale (bound "
        f"{ready['staleness_bound_ms']:.0f}), in {ready_ms:.1f} ms; {entry.distro}'s queue "
        f"route equal on the replica and the service; a push with another secret 401, the "
        f"signed one (posted as the replica listened) forwarded raw in {hook_ms:.1f} ms, "
        f"version {vid} read back at once, planned by the card's tick ({plan_s:.1f} s "
        f"waited here), its tasks {sorted(t['status'] for t in tasks)}; host spawn / extend / "
        f"stop / start / terminate and volume create / attach / detach / delete (host spawn "
        f"and volume create as processes, no torch, {min(procs):.1f}-{max(procs):.1f} s; the "
        f"rest in process, {min(inproc) * 1e3:.1f}-{max(inproc) * 1e3:.1f} ms) forwarded, "
        f"each read back from the replica at once and shown by the service; {ENTRY_FORWARDS} "
        f"forwarded writes ms p50 {fwd[len(fwd) // 2]:.1f}, p99 "
        f"{fwd[min(len(fwd) - 1, int(0.99 * len(fwd)))]:.1f}; a write marked "
        f"X-Evg-Forwarded refused 503; SIGTERM: exit 0; no torch, no probe imported")
    return {"boot_s": boot_s, "forward_ms": fwd}


def entry_admin(entry, base) -> dict:
    """The ``version`` and ``admin`` commands as processes (``-X
    importtime``), all three at once: ``version`` prints the package's
    line; ``admin set-flag`` aimed at the replica with ``ENTRY_VIEWER``'s
    key prints the 403 answer (and that user's read of the settings is
    refused 403); with the superuser's key it sets
    ``service_flags.ENTRY_FLAG``, a write the replica forwards to the
    service, read back from the replica at once and from the service's own
    settings. None imports ``torch``. Returns the service's tick and
    capacity-phase counts (``/metrics``) just before the write."""
    check(entry.replica_listening.wait(ENTRY_BOOT_S), "entry: the replica printed no "
          "listening line")
    if entry.replica_error is not None:
        raise entry.replica_error
    rbase = entry.replica_base
    samples = parse_exposition(http_text(base, "/metrics")[2])
    at_write = {"ticks": series_sum(samples, "scheduler_ticks_total"),
                "capacity": series(samples, "scheduler_tick_phase_duration_ms_count",
                                   phase="capacity")}
    check(at_write["capacity"] >= 1, f"entry: the service's ticks ran no capacity phase "
          f"before the flag: {at_write}")

    def cli(*argv):
        return subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE))

    t0 = time.perf_counter()
    procs = {
        "version": cli("version"),
        "denied": cli("admin", "set-flag", "--flag", ENTRY_FLAG, "--api-server", rbase,
                      "--api-user", ENTRY_VIEWER[0], "--api-key", ENTRY_VIEWER[1]),
        "set": cli("admin", "set-flag", "--flag", ENTRY_FLAG, "--api-server", rbase,
                   "--api-user", INGEST_USER[0], "--api-key", INGEST_USER[1]),
    }
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        check(proc.returncode == 0, f"entry: the {name} command exited {proc.returncode}: "
              f"{stderr[-500:]}")
        check_no_torch(stderr, f"the {name} command")
        out[name] = stdout
    wall_s = time.perf_counter() - t0
    from evergreen_tpu_torch import __version__

    check(out["version"] == f"evergreen-tpu {__version__}\n",
          f"entry: version printed {out['version']!r}")
    check(json.loads(out["denied"]) == {"error": "admin scope required"},
          f"entry: the viewer's admin write answered {out['denied']!r}")
    check(json.loads(out["set"]) == {"updated": ["service_flags"]},
          f"entry: the superuser's admin write answered {out['set']!r}")
    viewer = {"Api-User": ENTRY_VIEWER[0], "Api-Key": ENTRY_VIEWER[1]}
    st, got = http_json(rbase, "GET", "/rest/v2/admin/settings", headers=viewer)
    check((st, got) == (403, {"error": "superuser scope required"}),
          f"entry: the viewer's read of admin/settings answered {st} {str(got)[:200]}")
    flags = {}
    for who, url in (("replica", rbase), ("service", base)):
        st, got = http_json(url, "GET", "/rest/v2/admin/settings", headers=api_headers())
        check(st == 200, f"entry: admin/settings on the {who} answered {st}")
        flags[who] = got["service_flags"][ENTRY_FLAG]
    check(flags == {"replica": True, "service": True},
          f"entry: {ENTRY_FLAG} read back {flags}")
    log(f"entry: version, admin set-flag as {ENTRY_VIEWER[0]} and as {INGEST_USER[0]}, "
        f"three processes aimed at the replica in {wall_s:.1f} s, none importing torch: "
        f"{out['version'].strip()!r}; the viewer's write 403 ({out['denied'].strip()}); "
        f"the superuser's forwarded ({out['set'].strip()}), {ENTRY_FLAG} read back on the "
        f"replica and the service; the service had run {at_write['ticks']:.0f} ticks, "
        f"{at_write['capacity']:.0f} with the capacity phase")
    return at_write


def entry_admin_read(base, at_write) -> int:
    """The service's ticks after ``entry_admin``'s write: once at least
    one tick has run without the capacity phase since the write (the tick
    in flight at the write may still carry the page), its tick job read
    ``ENTRY_FLAG``. Returns the count of ticks that ran the capacity
    phase, every one before the flag."""
    def read():
        samples = parse_exposition(http_text(base, "/metrics")[2])
        return (series_sum(samples, "scheduler_ticks_total"),
                series(samples, "scheduler_tick_phase_duration_ms_count", phase="capacity"))

    t0 = time.perf_counter()
    ticks, cap = eventually(
        read, lambda got: got[0] - at_write["ticks"] > got[1] - at_write["capacity"],
        "a tick without the capacity phase after the flag", timeout_s=60.0)
    check(cap - at_write["capacity"] <= 1, f"entry: {cap - at_write['capacity']:.0f} ticks "
          f"ran the capacity phase after {ENTRY_FLAG} was set")
    log(f"entry: after {ENTRY_FLAG}, the service ran {ticks - at_write['ticks']:.0f} ticks, "
        f"{cap - at_write['capacity']:.0f} with the capacity phase (the one in flight at "
        f"the write); waited {time.perf_counter() - t0:.1f} s for it here")
    return int(cap)


def gql_http(base, doc, variables=None, headers=None) -> tuple:
    """One ``POST /graphql`` over HTTP: (status, answer)."""
    return http_json(base, "POST", "/graphql", {"query": doc, "variables": variables or {}},
                     headers=headers or api_headers())


ENTRY_QUEUE_DOC = ("query($d: String!) { taskQueue(distroId: $d) { id task_group "
                   "dependencies_met } }")
ENTRY_TASK_DOC = "query($t: String!) { task(taskId: $t) { id priority } }"
ENTRY_PRIORITY_DOC = ("mutation($t: String!, $p: Int!) { setTaskPriority(taskId: $t, "
                      "priority: $p) { id priority } }")


def entry_graphql_write(entry, base) -> dict:
    """Phase 13's GraphQL write, early, so that the service's ticks plan it
    while the agents run: with the API user's key, ``taskQueueDistros``
    (served by the service's follower: ``extensions.served_by``), the
    longest queue outside the agents' distro (``taskQueue``), and
    ``setTaskPriority`` to ``GQL_PRIORITY`` on its last task outside any
    task group with its dependencies met. Returns what ``entry_graphql``
    holds."""
    t0 = time.perf_counter()
    st, out = gql_http(base, "{ taskQueueDistros { id taskCount hostCount } }")
    check(st == 200 and "errors" not in out, f"entry: taskQueueDistros answered {st} "
          f"{str(out)[:300]}")
    served = (out.get("extensions") or {}).get("served_by")
    dists = [d for d in out["data"]["taskQueueDistros"]
             if d["id"] != entry.distro and d["taskCount"]]
    check(dists, "entry: no queue outside the agents' distro")
    did = max(dists, key=lambda d: (d["taskCount"], d["id"]))["id"]
    st, out = gql_http(base, ENTRY_QUEUE_DOC, {"d": did})
    check(st == 200 and "errors" not in out, f"entry: taskQueue answered {st}")
    ids = [i["id"] for i in out["data"]["taskQueue"]]
    cand = [i["id"] for i in out["data"]["taskQueue"]
            if not i["task_group"] and i["dependencies_met"]]
    check(len(cand) >= 2, f"entry: {len(cand)} tasks of {did} to raise")
    st, out = gql_http(base, ENTRY_PRIORITY_DOC, {"t": cand[-1], "p": GQL_PRIORITY})
    check(st == 200 and out.get("data", {}).get("setTaskPriority", {}).get("priority")
          == GQL_PRIORITY, f"entry: setTaskPriority answered {st} {str(out)[:300]}")
    return {"distro": did, "task": cand[-1], "other": cand[-2], "pos": ids.index(cand[-1]),
            "n": len(ids), "served": served, "ms": (time.perf_counter() - t0) * 1e3}


def entry_graphql(entry, base, w) -> dict:
    """Phase 13's GraphQL reads, the replica's included, before the replica
    stops. Holds: a tick of the service planned ``entry_graphql_write``'s
    raise (its queue item carries the priority and moved up); through the
    replica (``service --replica-of``) a query served from its own tail, and
    a ``setTaskPriority`` forwarded to the service, read back from the
    replica at once and shown by the service; the service's follower
    answered the first query (``extensions.served_by``); the viewer's
    ``adminSettings`` fails with the JAX package's error; and ``GET /``
    serves the page."""
    from evergreen_tpu_torch.api import ui

    check(isinstance(w["served"], str) and w["served"],
          f"entry: taskQueueDistros was served by {w['served']!r}")
    t0 = time.perf_counter()
    qpath = f"/rest/v2/distros/{w['distro']}/queue"

    def placed(got):
        st, q = got
        items = q.get("queue", []) if st == 200 else []
        ids = [i["id"] for i in items]
        return (w["task"] in ids and ids.index(w["task"]) < w["pos"]
                and items[ids.index(w["task"])]["priority"] == GQL_PRIORITY)

    st, q = eventually(lambda: http_json(base, "GET", qpath, headers=api_headers()), placed,
                       f"a tick that plans the raise of {w['task']}", ENTRY_PLAN_S)
    plan_s = time.perf_counter() - t0
    pos = [i["id"] for i in q["queue"]].index(w["task"])
    check(entry.replica_listening.wait(ENTRY_BOOT_S), "entry: the replica printed no "
          "listening line")
    rbase = entry.replica_base
    st, local = eventually(lambda: gql_http(rbase, ENTRY_TASK_DOC, {"t": w["task"]}),
                           lambda got: got[0] == 200 and got[1].get("data", {}).get("task")
                           == {"id": w["task"], "priority": GQL_PRIORITY},
                           "the replica reads the raise")
    check("extensions" not in local, f"entry: the replica's own answer {local}")
    t1 = time.perf_counter()
    st, fwd = gql_http(rbase, ENTRY_PRIORITY_DOC, {"t": w["other"], "p": GQL_PRIORITY - 1})
    fwd_ms = (time.perf_counter() - t1) * 1e3
    check(st == 200 and fwd.get("data", {}).get("setTaskPriority", {}).get("priority")
          == GQL_PRIORITY - 1, f"entry: the mutation through the replica answered {st} {fwd}")
    st, back = gql_http(rbase, ENTRY_TASK_DOC, {"t": w["other"]})
    check(st == 200 and back["data"]["task"]["priority"] == GQL_PRIORITY - 1,
          f"entry: the replica read its forwarded mutation back as {back}")
    eventually(lambda: gql_http(base, ENTRY_TASK_DOC, {"t": w["other"]}),
               lambda got: got[0] == 200 and got[1].get("data", {}).get("task", {})
               .get("priority") == GQL_PRIORITY - 1,
               "the service shows the mutation forwarded through the replica")
    viewer = {"Api-User": ENTRY_VIEWER[0], "Api-Key": ENTRY_VIEWER[1]}
    st, denied = gql_http(base, "{ adminSettings }", headers=viewer)
    check(st == 200 and denied == {"errors": [{"message": "admin access required"}]},
          f"entry: the viewer's adminSettings answered {st} {denied}")
    st, ctype, page = http_text(base, "/")
    check(st == 200 and ctype == "text/html" and page == ui.PAGE,
          f"entry: GET / answered {st} {ctype} ({len(page)} characters)")
    log(f"entry: GraphQL with the API user's key: taskQueueDistros served by the service's "
        f"follower ({w['served']}), {w['distro']}'s queue ({w['n']} items), and "
        f"setTaskPriority {GQL_PRIORITY} on {w['task']} at {w['pos']} in {w['ms']:.1f} ms "
        f"in all; a tick of the service planned it at {pos} with its priority (waited "
        f"{plan_s:.1f} s here); the replica read it from its own tail (no extensions), "
        f"forwarded setTaskPriority on {w['other']} in {fwd_ms:.1f} ms and read it back at "
        f"once, the service showing it; the viewer's adminSettings: "
        f"{denied['errors'][0]['message']!r}; GET / served the page ({len(page)} "
        f"characters)")
    return {"plan_s": plan_s, "forward_ms": fwd_ms}


# ---- the smoke command, a process beside phases 12 and 13 ------------------- #

SMOKE_WAIT_S = 300.0


def start_smoke(card="cuda") -> dict:
    """``python -m evergreen_tpu_torch smoke`` (on the CPU with
    ``card="cpu"``), its output into unnamed files, and a thread that
    notes when it exits."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    argv = [sys.executable, "-m", "evergreen_tpu_torch", "smoke"]
    if card != "cuda":
        argv += ["--device", "cpu"]
    smoke = {"out": out, "err": err, "t0": time.perf_counter(), "card": card}
    smoke["proc"] = subprocess.Popen(argv, stdout=out, stderr=err, text=True, cwd=HERE,
                                     env=dict(os.environ, PYTHONPATH=HERE))

    def waiter():
        smoke["proc"].wait()
        smoke["t_end"] = time.perf_counter()

    smoke["waiter"] = threading.Thread(target=waiter, daemon=True)
    smoke["waiter"].start()
    return smoke


def stop_smoke(smoke) -> None:
    if smoke is not None and smoke["proc"].poll() is None:
        smoke["proc"].kill()
        smoke["proc"].wait(timeout=30)


def join_smoke(smoke) -> dict:
    """Waits for the smoke process. Holds: exit 0, ``SMOKE OK``, the
    sample project's three tasks succeeded, ``graphql agrees: success``,
    the device it names (``cuda`` on the card), and on the card its
    launch line exact for its solves: ``expected_launches`` of some ticks
    with the capacity page and the rest without. Returns its launches."""
    from evergreen_tpu_torch.settings import CapacityConfig

    proc = smoke["proc"]
    rc = proc.wait(timeout=SMOKE_WAIT_S)
    smoke["waiter"].join(timeout=30)
    wall_s = smoke["t_end"] - smoke["t0"]
    smoke["out"].seek(0)
    smoke["err"].seek(0)
    out, err = smoke["out"].read().splitlines(), smoke["err"].read()
    smoke["out"].close()
    smoke["err"].close()
    check(rc == 0 and out and out[-1] == "SMOKE OK",
          f"smoke: exited {rc}: {' | '.join(out[-6:])} {err[-500:]}")
    device = "cuda" if smoke["card"] == "cuda" else "cpu"
    check(out[0] == f"device: {device}", f"smoke: ran on {out[0]!r}")
    results = [x.split() for x in out if x.startswith("  ")]
    check(results == [["compile", "success"], ["lint", "success"],
                      ["unit-tests", "success"]]
          and "graphql agrees: success" in out and "version status: success" in out,
          f"smoke: results {results}, {[x for x in out if 'graphql' in x]}")
    launches = {}
    if device == "cuda":
        line = next(x for x in out if x.startswith("kernel launches: "))
        launches = json.loads(line[len("kernel launches: "):])
        n = launches.get("fused_distro_stats", 0)
        iters = CapacityConfig().iterations
        fits = [k for k in range(n + 1)
                if expected_launches([iters] * k + [0] * (n - k)) == launches]
        check(n > 0 and fits, f"smoke: launches {launches} fit no {n} solves")
    log(f"smoke: python -m evergreen_tpu_torch smoke, its own process and in-memory "
        f"store beside phases 12 and 13: exit 0 in {wall_s:.1f} s, on {device}, the three "
        f"tasks succeeded, GraphQL agrees; launches {launches}"
        + (f" (exact for {launches['fused_distro_stats']} solves, {fits[0]} with the "
           f"capacity page)" if launches else ""))
    READINGS["smoke s"] = wall_s
    return launches


def entry_phase(torch, entry) -> dict:
    """Phase 13: the deployed entry points. The single-store service
    (``python -m evergreen_tpu_torch service --data-dir D --port 0
    --workers 1 --require-auth``: the card's probe, the environment, the
    cron plane's ticks on the card, the REST agent surface) started during
    phase 12 on a copy of its seeded directory; ``ENTRY_AGENTS`` ``python
    -m evergreen_tpu_torch agent --once`` processes, each with its host's
    credentials, pull from it and run what they are handed; then SIGTERM.
    Holds: each agent completed a task and imported no ``torch`` and no
    probe (``-X importtime``); the patch's tasks succeeded, and a user's
    loop over them (``entry_user_loop``) holds; the service exits 0 with its writer lease
    released; reopened, the directory holds the agents' ends, and every
    tick the service ran planned on the card, not degraded, with the
    launches its drain line prints exactly those of that many solves.
    Returns those launches."""
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.lease import FileLease

    on_card = torch.cuda.is_available() and "--device" not in entry.device_args
    check(entry.listening.wait(ENTRY_BOOT_S), "entry: the service printed no listening "
          "line")
    if entry.error is not None:
        raise entry.error
    listen = entry.line("evergreen_tpu_torch service listening on")
    check(listen is not None, "entry: the service exited before it listened: "
          + " | ".join(x for _, x in entry.lines[-5:]))
    t_listen = next(t for t, x in entry.lines if x == listen)
    base = "http://" + listen.split("listening on ")[1].split()[0]
    boot = json.loads(entry.line("boot ms: ")[len("boot ms: "):])
    log(f"entry: the directory prepared in {entry.prep_s:.1f} s (during "
        f"phase 12); the service listened {t_listen - entry.t_spawn:.1f} s after its spawn "
        f"({entry.line('recovery: ')}; boot ms {boot}); {base}")
    patch_ids, patch_id = entry_patch_planned(entry, base)
    hook_version, hook_ids = entry_hook_planned(entry, base)
    # the GraphQL raise, planned by the service's ticks while the agents run
    raised = entry_graphql_write(entry, base)
    t0 = time.perf_counter()
    procs = []
    for hid, secret in entry.agents:
        work = os.path.join(entry.root, f"entry-agent-{hid}")
        procs.append((hid, subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch", "agent",
             "--api-server", base, "--host-id", hid, "--host-secret", secret,
             "--working-dir", work, "--once"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE))))
    completed = {}
    for hid, proc in procs:
        out, err = proc.communicate(timeout=ENTRY_AGENT_S)
        check(proc.returncode == 0, f"entry: agent {hid} exited {proc.returncode}: "
              + err[-500:])
        check_no_torch(err, f"agent {hid}")
        completed[hid] = [x.split()[-1] for x in out.splitlines()
                          if x.startswith("completed task")]
        check(completed[hid], f"entry: agent {hid} completed no task: {out[-300:]}")
    agents_s = time.perf_counter() - t0
    # the flag after the agents, whose work the service's ticks plan
    # with the capacity page; the tick it reads comes during the reads
    at_write = entry_admin(entry, base)
    entry_patch_done(base, patch_ids, patch_id)
    hooked = {t: http_json(base, "GET", f"/rest/v2/tasks/{t}", headers=api_headers())[1]
              .get("status") for t in hook_ids}
    log(f"entry: after the agents, the pushed version {hook_version}'s tasks {hooked}")
    entry_user_loop(entry, base, patch_ids)
    entry_operator(base)
    entry_graphql(entry, base, raised)
    entry_replica(entry, base)
    with_page = entry_admin_read(base, at_write)
    t0 = time.perf_counter()
    entry.proc.send_signal(signal.SIGTERM)
    rc = entry.proc.wait(timeout=120)
    entry.thread.join(timeout=30)
    drain_s = time.perf_counter() - t0
    entry.stderr.close()
    check(rc == 0, f"entry: the service exited {rc} on SIGTERM")
    check(entry.line("service drained; the writer lease released") is not None,
          "entry: the service printed no drain line")
    probe = FileLease(os.path.join(entry.data_dir, "writer.lease"))
    check(probe.try_acquire(), "entry: the service's writer lease was not released")
    probe.release()
    t0 = time.perf_counter()
    store = DurableStore(entry.data_dir)
    try:
        reopen_s = time.perf_counter() - t0
        tasks = store.collection("tasks")
        done = [tid for tids in completed.values() for tid in tids]
        finished = {tid: tasks.get(tid)["status"] for tid in done}
        check(all(st in ("success", "failed") and tasks.get(tid)["finish_time"] > 0
                  for tid, st in finished.items()),
              f"entry: the agents' tasks are not finished in the directory: {finished}")
        ticks = [d["attributes"] for d in store.collection("spans").find()
                 if d["name"] == "tick"]
        check(ticks and all((t["planner_used"], t["degraded"]) == ("tpu", "")
                            for t in ticks),
              f"entry: the service's ticks {[(t['planner_used'], t['degraded']) for t in ticks]}")
    finally:
        store._journal.close()
    launches = {}
    if on_card:
        launches = json.loads(entry.line("kernel launches: ")[len("kernel launches: "):])
        # the ticks after the flag solved without the capacity page
        check(0 < with_page < len(ticks), f"entry: {with_page} of {len(ticks)} ticks "
              f"ran the capacity phase")
        want = expected_launches([CapacityConfig().iterations] * with_page
                                 + [0] * (len(ticks) - with_page))
        check(launches == want, f"entry: the service's launches {launches}, expected "
              f"{want} for {len(ticks)} ticks, {with_page} with the capacity page")
    log(f"entry: {len(procs)} agent processes completed "
        f"{sum(map(len, completed.values()))} tasks in {agents_s:.1f} s "
        f"({', '.join(f'{h} {len(t)}' for h, t in completed.items())}), none imported "
        f"torch or the probe; SIGTERM drained the service in {drain_s:.1f} s, exit 0, "
        f"its lease released; reopened in {reopen_s:.1f} s, the directory holds their "
        f"ends and {len(ticks)} ticks, each planned by the card, not degraded; launches "
        f"{launches} (exact for {len(ticks)} solves, {with_page} with the capacity "
        f"page)")
    return launches


def entry_phases(torch, np, problem, smi, phase_done, card="cuda", root=DATA_ROOT,
                 entry_root=ENTRY_ROOT, scenarios=None) -> tuple:
    """Phases 12 and 13, with phase 13's service process started from
    phase 12 once its directory is seeded, and stopped whatever happens.
    The ``smoke`` command runs as a process of its own beside both
    (``start_smoke``, ``join_smoke``). With the scenario process
    (``scenarios``), phase 13 starts ``replay-trace`` on its step 4's
    trace file on ``card`` once it is written, and, once the service has
    drained, a compile of the service's own capture (``replay-trace
    --no-run``): its spec's tick-0 fleet holds the agents' distro.
    Returns (phase 12's card launches before the push, after it, phase
    13's service's, phase 12's cold tick's, the smoke process's, the
    replay process's). ``card="cpu"`` rehearses both on the CPU (pass
    roots outside the checkout)."""
    import shutil

    entry = EntryService(entry_root, () if card == "cuda" else ("--device", "cpu"))
    shutil.rmtree(entry_root, ignore_errors=True)
    os.makedirs(entry_root)
    smoke = replay = compiled = None
    replayed = {}
    try:
        smoke = start_smoke(card)
        log(f"job plane, REST agent surface and ingestion on {smi}")
        cron = cron_phase(torch, np, problem, card=card, root=root, on_seed=entry.start)
        phase_done("phase 12")
        log(f"entry points on {smi}")
        if scenarios is not None:
            t0 = time.perf_counter()
            check(scenarios["trace_ready"].wait(SCENARIO_WAIT_S),
                  "the scenario process wrote no trace file")
            log(f"waited {time.perf_counter() - t0:.1f} s for the scenario process's "
                f"trace file")
            trace_file = os.path.join(SCENARIO_ROOT, "region-failover.jsonl")
            if not os.path.exists(trace_file):
                join_scenario_child(scenarios)  # raises with the process's failure
            replay = start_replay(trace_file, card)
        rest = entry_phase(torch, entry)
        if scenarios is not None:
            spec_path = os.path.join(entry_root, "service-spec.json")
            compiled = start_replay(entry.capture, card, out_spec=spec_path)
        smoked = join_smoke(smoke)
        if scenarios is not None:
            out, replayed, wall_s = join_replay(replay)
            log(f"replay-trace of the scenario process's region-failover trace: exit 0 in "
                f"{wall_s:.1f} s, ok and deterministic; launches {replayed}")
            _, _, compile_s = join_replay(compiled)
            with open(spec_path) as fh:
                spec = json.load(fh)
            fleet = next(e for e in spec["events"] if e["kind"] == "fleet" and e["tick"] == 0)
            ids = [d["id"] for d in fleet["args"]["distros"]]
            check(entry.distro in ids, f"the service's capture: the agents' distro "
                  f"{entry.distro} is not in the tick-0 fleet {ids[:10]}")
            log(f"replay-trace --no-run of the service's capture "
                f"({os.path.getsize(entry.capture)} bytes): exit 0 in {compile_s:.1f} s; "
                f"its spec has {len(spec['events'])} events over {spec['ticks']} ticks, "
                f"{len(ids)} distros in its tick-0 fleet, the agents' {entry.distro} among "
                f"them")
        phase_done("phase 13")
    finally:
        entry.stop()
        stop_smoke(smoke)
        stop_replay(replay)
        stop_replay(compiled)
    shutil.rmtree(entry_root, ignore_errors=True)
    return cron["cron"], cron["ingest"], rest, cron["cold"], smoked, replayed


#: the packer check's cold builds of config 3 on each packer, alternated
PACK_REPS = 3


def packer_phase(np, problem) -> dict:
    """The evgpack C packer (``utils/native.py``) at config 3 against its
    pure-Python plain version: ``PACK_REPS`` cold ``build_snapshot``s on
    each, alternated, every arena byte-identical; then a resident plane
    on each (config 3 less its last distro: a cold rebuild, then the
    distro added: the distro-set change), both syncs' arenas
    byte-identical and equal to a cold build of the same gather. Returns
    the median pack ms of each and the planes' sync ms."""
    from evergreen_tpu_torch.scheduler.cache import TickCache
    from evergreen_tpu_torch.scheduler.resident import ResidentPlane, canonicalize
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import native
    from evergreen_tpu_torch.utils.benchgen import NOW

    @contextlib.contextmanager
    def packer(name):
        saved = native._module, native._attempted
        if name == "plain":
            native._module, native._attempted = None, True
        try:
            yield
        finally:
            native._module, native._attempted = saved

    def arena_bytes(snap):
        return {k: np.asarray(v).tobytes() for k, v in snap.arena.buffers.items()}

    # loaded (phase 1 built it) before anything is timed
    check(native.evgpack_status() == "native",
          f"packer: evgpack_status() is {native.evgpack_status()!r}")
    ms = {"native": [], "plain": []}
    first = {}
    for name in ("native", "plain", "plain", "native") * ((PACK_REPS + 1) // 2):
        if len(ms[name]) == PACK_REPS:
            continue
        with packer(name):
            t0 = time.perf_counter()
            snap = build_snapshot(*problem, NOW)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        got = arena_bytes(snap)
        snap.arena.close()
        want = first.setdefault("cold", got)
        check(got == want, f"packer: a cold build_snapshot on the {name} packer differs")
    distros = problem[0]
    held = distros[-1].id
    plane_ms, bufs = {}, {}
    for name in ("native", "plain"):
        store = Store()
        seed_tick_store(store, problem, only={d.id for d in distros[:-1]})
        cache, plane = TickCache(store), ResidentPlane(store)
        for step in ("cold", "distro-set"):
            if step == "distro-set":
                seed_tick_store(store, problem, only={held})
            with packer(name):
                gathered = cache.gather(NOW)
                t0 = time.perf_counter()
                snap = plane.sync(cache, *gathered, NOW)
                plane_ms[(name, step)] = (time.perf_counter() - t0) * 1e3
                check(snap is not None, f"packer: the {name} plane fell back at {step}")
                cold = build_snapshot(*gathered, NOW)
            check(canonicalize(snap) == canonicalize(cold),
                  f"packer: the {name} plane's {step} sync differs from a cold build")
            cold.arena.close()
            bufs[(name, step)] = arena_bytes(snap)
            snap.arena.close()
        plane_ms[(name, "how")] = (
            "spliced" if plane.topology_splices else "rebuilt")
    for step in ("cold", "distro-set"):
        check(bufs[("native", step)] == bufs[("plain", step)],
              f"packer: the resident plane's {step} arenas differ between the packers")
    med = {k: statistics.median(v) for k, v in ms.items()}
    log(f"packer at config 3 ({native.evgpack_status()}): cold build_snapshot median "
        f"{med['native']:.1f} ms native, {med['plain']:.1f} ms plain (over {PACK_REPS} "
        f"each, alternated: " + ", ".join(f"{k} {[round(x, 1) for x in v]}"
                                          for k, v in ms.items())
        + "), arenas byte-identical; the resident plane's cold rebuild "
        f"{plane_ms[('native', 'cold')]:.1f} / {plane_ms[('plain', 'cold')]:.1f} ms and "
        f"its distro-set change ({plane_ms[('native', 'how')]}) "
        f"{plane_ms[('native', 'distro-set')]:.1f} / {plane_ms[('plain', 'distro-set')]:.1f} "
        f"ms (native / plain), arenas byte-identical and equal to cold builds")
    # the stores and snapshots are cyclic garbage: collect it now, before
    # the card's work, where a full collection would stall the ticks
    import gc

    gc.collect()
    return {"native_ms": med["native"], "plain_ms": med["plain"]}


def live_children() -> list:
    """The pids of this process's children that are still running (not
    zombies), but multiprocessing's resource tracker, which ends when this
    process does."""
    from multiprocessing import resource_tracker

    tracker = getattr(resource_tracker._resource_tracker, "_pid", None)
    me, left = str(os.getpid()), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == tracker:
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                state, ppid = fh.read().rsplit(")", 1)[1].split()[:2]
        except OSError:
            continue
        if ppid == me and state != "Z":
            left.append(int(pid))
    return left


def recovery_counts(report) -> dict:
    """A recovery report's counts, for the log."""
    return {k: len(v) if isinstance(v, list) else v
            for k, v in report.to_doc().items()}



def main() -> int:
    profile_dir = None
    sweep_mode = sys.argv[1:] == ["--sweep"]
    procs_mode = sys.argv[1:] == ["--procs"]
    crash_mode = sys.argv[1:] == ["--crash"]
    matrices_mode = sys.argv[1:] == ["--matrices"]
    net_mode = sys.argv[1:] == ["--net"]
    timed = fleets = None
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile_dir = sys.argv[2]
    elif len(sys.argv) in (3, 4) and sys.argv[1] == "--timed" and sys.argv[2].isdigit():
        timed = (int(sys.argv[2]), sys.argv[3] if len(sys.argv) == 4 else None)
    elif len(sys.argv) == 3 and sys.argv[1] == "--fleet-crash" and sys.argv[2].isdigit():
        fleets = int(sys.argv[2])
    elif len(sys.argv) != 1 and not (sweep_mode or procs_mode or crash_mode
                                     or matrices_mode or net_mode):
        print("usage: chip_smoke.py [--profile OUT_DIR | --sweep | --procs | --crash | "
              "--matrices | --net | --timed N [ROOT] | --fleet-crash N]", file=sys.stderr)
        return 2
    side_mode = (sweep_mode or procs_mode or crash_mode or matrices_mode or net_mode
                 or timed is not None or fleets is not None)
    if not os.path.isdir(os.path.join(HERE, "evergreen_tpu_torch")):
        print("chip_smoke: evergreen_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # the run uses one card: keep only the first visible one, so that the
    # device count in the last line is the count of cards the run used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if visible is None else visible.split(",")[0])
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    check(torch.cuda.device_count() == 1, "expected exactly one visible card")
    # phase 4's worker processes start now: their imports overlap the
    # backend probe and the build
    workers = None if side_mode else start_stacked_workers()

    # the backend probe: a fresh interpreter must see the card
    from evergreen_tpu_torch.utils.torchenv import ensure_usable_backend

    backend = ensure_usable_backend()  # one probe_backend_detail() in a fresh interpreter
    log(f"backend probe: ensure_usable_backend() = {backend!r}")
    check(backend == "cuda", f"ensure_usable_backend() returned {backend!r}")

    from evergreen_tpu_torch.api.sidecar import SidecarClient, serve_background
    from evergreen_tpu_torch.ops import _build
    from evergreen_tpu_torch.ops.distro_stats import (
        fused_distro_stats,
        fused_distro_stats_plain,
    )
    from evergreen_tpu_torch.ops.packing import unpack
    from evergreen_tpu_torch.ops.segment import (
        segment_plan,
        segment_sum,
        segment_sum_plain,
    )
    from evergreen_tpu_torch.ops.solve import (
        OUTPUT_SPEC,
        _packed_solve,
        capacity_iters,
        distro_stats_inputs,
        result_to_host,
        run_solve_packed,
        split_outputs,
    )
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.utils.benchgen import (
        NOW,
        add_capacity_page,
        generate_problem,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = last = time.perf_counter()

    walls = {}

    def phase_done(name):
        """Log the wall seconds of the phase that just ended."""
        nonlocal last
        now = time.perf_counter()
        walls[name] = now - last
        log(f"{name}: {now - last:.1f} s wall ({now - t_start:.1f} s since the card "
            f"was set)")
        last = now

    # ---- 1. card and build ------------------------------------------------- #
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    kernels = ("distro_stats", "segment_sum")
    t0 = time.perf_counter()
    build_s = _build.build(kernels)
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        + " ".join(f"{k}={s:.2f}s" for k, s in build_s.items()))
    # the snapshot's C packer, built with g++ at first use like the JAX
    # package's; never a silent fallback
    from evergreen_tpu_torch.utils import native

    t0 = time.perf_counter()
    packer = native.evgpack_status()
    log(f"evgpack: evgpack_status() = {packer!r} in {time.perf_counter() - t0:.2f} s "
        f"(g++ build of {os.path.relpath(native.SOURCE, HERE)} if none was built)")
    check(packer == "native", f"evgpack_status() is {packer!r}: {native.build_error[-1500:]}")
    for k in kernels:
        logf = _build.build_log(k)
        if os.path.exists(logf):
            with open(logf) as f:
                for line in f.read().splitlines():
                    if "registers" in line or "spill" in line:
                        log(f"  ptxas {k}: {line.strip()}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = float(clock.split()[0])
    if procs_mode:
        procs_timing()
        print(smi)
        return 0
    if timed is not None:
        timed_rounds(*timed)
        print(smi)
        return 0
    if crash_mode:
        crash_alone()
        print(smi)
        return 0
    if matrices_mode:
        matrices_alone()
        print(smi)
        return 0
    if net_mode:
        net_alone()
        print(smi)
        return 0
    if fleets is not None:
        fleet_crash(fleets)
        print(smi)
        return 0
    if workers is not None:
        waited = wait_stacked_workers(workers)
        log(f"phase 4's worker processes ready {time.perf_counter() - workers['t0']:.2f} s "
            f"after their start (waited {waited:.2f} s for them here, before the "
            f"first profile)")
    # the launch floor: the device time of the smallest kernel there is
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(torch, lambda: one.add_(1.0))
    log(f"SM clock for the chain bounds: {sm_mhz:.0f} MHz (clocks.max.sm "
        f"'{clock}'); launch floor (one-element add_): {floor_ms * 1e3:.2f} us "
        f"device time")

    # ---- config-3 snapshots (host side) ------------------------------------ #
    t0 = time.perf_counter()
    problems = {
        "seed0": generate_problem(*CONFIG3, seed=SEED),
        "seed1": generate_problem(*CONFIG3, seed=SEED + 1),
    }
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snaps = {
        "seed0": build_snapshot(*problems["seed0"], NOW),
        "seed0+cap": add_capacity_page(build_snapshot(*problems["seed0"], NOW)),
        "seed1": build_snapshot(*problems["seed1"], NOW),
    }
    build_snap_s = (time.perf_counter() - t0) / 3
    s0 = snaps["seed0"]
    log(f"config 3: generate {gen_s:.2f} s for two seeds, snapshot build "
        f"{build_snap_s * 1e3:.0f} ms (host, the evgpack packer); shape key "
        f"(N,M,U,G,H,D,P,C) = {s0.shape_key()}; tasks {s0.n_tasks}, hosts "
        f"{s0.n_hosts}, distros {s0.n_distros}, segments {s0.n_segs}")
    # ---- 2. kernels against their plain versions on the card -------------- #
    a = unpack(s0.arena.buffers, s0.arena.layout_key(), dev)
    D = a["d_valid"].shape[0]
    rows = []

    ds_args = distro_stats_inputs(a)
    if sweep_mode:
        sweep(torch, ds_args, segment_inputs(torch, np, a, ds_args[6]))
        print(smi)
        return 0

    # fused_distro_stats at the allocator's inputs + the ragged cases
    ds_cases = [ds_args]
    for counts, cols, th in ragged_cases(np):
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        ds_cases.append(tuple(
            torch.as_tensor(cols[c]).to(dev) for c in (
                "t_valid", "t_deps_met", "t_expected_s", "t_wait_dep_met_s",
                "t_is_merge")
        ) + (torch.as_tensor(offs).to(dev), torch.as_tensor(th).to(dev)))
    ds_err = max(hold_distro_stats(torch, args) for args in ds_cases)
    log(f"fused_distro_stats: bit-equal to plain on the CPU on {len(ds_cases)} "
        f"inputs (counts and both duration sums); against plain on the card "
        f"(atomic index_add_) counts exact, sums within rtol {SUM_RTOL}, max abs "
        f"err {ds_err:.3g}")

    def seven_index_adds():
        out = torch.zeros((7, D), dtype=torch.float32, device=dev)
        for k, col in enumerate(ds_cols):
            out[k].index_add_(0, t_distro, col)
        return out

    t_distro = a["t_distro"].long()
    dm = a["t_valid"] & a["t_deps_met"]
    t_thresh = ds_args[6][t_distro]
    over = dm & (a["t_expected_s"] > t_thresh)
    ds_cols = (
        a["t_valid"].float(), dm.float(), torch.where(dm, a["t_expected_s"], 0.0),
        over.float(), torch.where(over, a["t_expected_s"], 0.0),
        (dm & (a["t_wait_dep_met_s"] > t_thresh)).float(),
        (dm & a["t_is_merge"]).float(),
    )
    # the kernel reads the tasks inside the distros' ranges once (three u8
    # flags, two f32 columns), the offsets and thresholds, and writes [D, 7];
    # each duration sum is one ordered chain over its distro, so the
    # longest distro's adds bound it too
    offs = ds_args[5]
    n_ranged = int(offs[-1])
    longest = int((offs[1:] - offs[:-1]).max())
    log(f"fused_distro_stats: {n_ranged} tasks in {D} distros, longest {longest}")
    rows.append(dict(
        name="fused_distro_stats", route="cuda",
        source="evergreen_tpu_torch/csrc/distro_stats.cu",
        replaces="evergreen_tpu/ops/pallas_kernels.py:71",
        max_abs_err=ds_err,
        **measure(torch, lambda: fused_distro_stats(*ds_args),
                  lambda: fused_distro_stats_plain(*ds_args), seven_index_adds),
        **bounds(bytes_=11 * n_ranged + 4 * (D + 1) + 4 * D + 4 * 7 * D,
                 ops=9 * n_ranged,
                 chain_ms=1e3 * longest * FADD_CYCLES / (sm_mhz * 1e6)),
    ))

    # segment_sum at the solve's three plans, each at one and two columns;
    # the kernels line takes the column count the solve uses most there
    plan_inputs = segment_inputs(torch, np, a, ds_args[6])
    for pname, (seg, n_seg, live, x2, main_k) in plan_inputs.items():
        plan, err = hold_segment_sum(torch, pname, seg, n_seg, live, x2)
        n_live = int(plan.offsets[-1])
        longest = int((plan.offsets[1:] - plan.offsets[:-1]).max())
        plan_ms = device_ms(torch, lambda: segment_plan(seg, n_seg, live))
        chain_ms = 1e3 * longest * FADD_CYCLES / (sm_mhz * 1e6)
        by_k = {}
        for k, x in ((1, x2[0]), (2, x2)):
            library = (
                (lambda x=x: torch.bincount(plan.seg, weights=x, minlength=n_seg))
                if k == 1 else
                (lambda x=x: torch.zeros((k, n_seg), device=dev).index_add_(
                    1, plan.seg, x))
            )
            by_k[k] = dict(
                max_abs_err=err,
                **measure(torch, lambda x=x: segment_sum(x, plan),
                          lambda x=x: segment_sum_plain(x, plan), library),
                # the function needs each live element's k f32 values and
                # i32 segment id once, and writes k f32 per segment; the
                # kernel's order and offsets are its own plan, not the
                # function's bytes
                **bounds(bytes_=(4 * k + 4) * n_live + 4 * k * n_seg,
                         ops=k * n_live, chain_ms=chain_ms),
            )
            log(f"segment_sum[{pname}] k={k}: {n_live} live elements in "
                f"{n_seg} segments, longest {longest}; " + fmt_row(by_k[k]))
        log(f"segment_sum[{pname}] plan build (sort + searchsorted, once per "
            f"solve): {plan_ms * 1e3:.2f} us device time")
        rows.append(dict(
            name=f"segment_sum[{pname}]", route="cuda",
            source="evergreen_tpu_torch/csrc/segment_sum.cu",
            replaces="evergreen_tpu/ops/solve.py:71", k=main_k, plan_ms=plan_ms,
            **by_k[main_k],
        ))
    log(f"segment_sum: bit-equal to the CPU at k = 1, 2 and within rtol "
        f"{SUM_RTOL} of index_add_ on {len(plan_inputs)} plans")
    for r in rows:
        r["floor_ms"] = floor_ms
        log(f"  {r['name']}" + (f" k={r['k']}" if "k" in r else "") + ": "
            + fmt_row(r) + f"; floor {floor_ms * 1e3:.2f} us")
    del a

    # ---- 3. the main path at config 3 ------------------------------------- #
    cpu_out = {name: run_solve_packed(s, device="cpu") for name, s in snaps.items()}
    for name, s in snaps.items():
        log(f"{name}: capacity iterations {capacity_iters(s)}")

    reset_launches(fused_distro_stats, segment_sum)
    lib_out = {name: run_solve_packed(s) for name, s in snaps.items()}
    server, port = serve_background("127.0.0.1", 0, device="cuda")
    client = SidecarClient("127.0.0.1", port)
    try:
        replies = {}
        for name, s in snaps.items():
            i32, f32 = client.solve(s)
            replies[name] = split_outputs(
                np.concatenate([i32, f32.view(np.int32)]), s.shape_key()
            )
        launches = read_launches(fused_distro_stats, segment_sum)
        n_solves = len(lib_out) + len(replies)
        log(f"main path: {n_solves} solves ({len(lib_out)} library calls, "
            f"{len(replies)} sidecar requests); launches {launches}")
        want = expected_launches([capacity_iters(s) for s in snaps.values()] * 2)
        check(launches == want, f"launches {launches}, expected exactly {want}")

        # each reply equals the library call: two card runs, byte for byte
        for name in snaps:
            for k in lib_out[name]:
                check(lib_out[name][k].tobytes() == replies[name][k].tobytes(),
                      f"{name}: sidecar reply {k} differs from the library call")
        log("sidecar replies are byte-identical to the library calls")
        gaps = {}
        for name, card in replies.items():
            for k, kind_, _ in OUTPUT_SPEC:
                c, w = card[k], cpu_out[name][k]
                if kind_ == "i32":
                    check(np.array_equal(c, w), f"{name}: {k} differs from the CPU run")
                else:
                    tol = F32_TOL.get(k, dict(rtol=0.0, atol=0.0))
                    np.testing.assert_allclose(c, w, err_msg=f"{name}: {k}", **tol)
                    rel = np.abs(c - w) / np.maximum(np.abs(w), 1e-30)
                    gaps[k] = max(gaps.get(k, 0.0), float(rel.max()) if len(c) else 0.0)
        log("card vs CPU: i32 outputs equal; f32 max relative gap "
            + ", ".join(f"{k}={v:.3g}" for k, v in gaps.items()))
        # sanity of the result itself: every real task queued exactly once,
        # in distro-major order, values finite
        for name, out in replies.items():
            s = snaps[name]
            order = out["order"]
            check(sorted(order.tolist()) == list(range(len(order))),
                  f"{name}: order is not a permutation")
            real = order[order < s.n_tasks]
            check(len(real) == s.n_tasks and np.array_equal(order[: s.n_tasks], real),
                  f"{name}: real tasks are not queued first")
            td = s.arrays["t_distro"][real]
            check(bool(np.all(np.diff(td) >= 0)), f"{name}: queues not distro-major")
            for k, kind_, _ in OUTPUT_SPEC:
                if kind_ == "f32":
                    check(bool(np.isfinite(out[k]).all()), f"{name}: {k} not finite")
            check(bool((out["d_new_hosts"] >= 0).all()), f"{name}: negative spawn count")
        check(not np.array_equal(replies["seed0+cap"]["cap_x"], replies["seed0"]["cap_x"]),
              "the capacity page did not move the capacity targets")
        log("result: queues are permutations, distro-major, f32 outputs "
            "finite, capacity targets moved by the page")

        # timings: sidecar request wall clock
        req_ms = []
        for _ in range(7):
            t0 = time.perf_counter()
            client.solve(snaps["seed0+cap"])
            req_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        client.close()
        server.shutdown()
        server.server_close()
    log(f"sidecar request (seed0+cap, config 3): median "
        f"{statistics.median(req_ms):.2f} ms wall over 7, min "
        f"{min(req_ms):.2f} ms")
    for name in ("seed0", "seed0+cap"):
        s = snaps[name]
        wall = []
        for _ in range(7):
            t0 = time.perf_counter()
            run_solve_packed(s)
            wall.append((time.perf_counter() - t0) * 1e3)
        log(f"run_solve_packed {name}: median {statistics.median(wall):.2f} ms "
            f"wall over 7 (H2D + solve + sync + D2H), min {min(wall):.2f} ms")
        profile_solve(
            torch,
            lambda: result_to_host(_packed_solve(
                s.arena.buffers, s.arena.layout_key(), capacity_iters(s), dev)),
            os.path.join(profile_dir, name) if profile_dir else None,
        )

    phase_done("phases 1-3")

    # ---- 4. stacked rounds; 5. the device mirror ------------------------- #
    stacked_phase(torch, np, problems["seed0"], F32_TOL, profile_dir, workers)
    phase_done("phase 4")
    mirror_phase(torch, np, problems["seed0"])
    phase_done("phase 5")

    # ---- 10's durable fleet and 11, the process fleet, in their process ----- #
    # (beside the rest of phase 9, phases 6 and 7 and phase 10's durable
    # tick, with which they share no store, directory or port; the
    # process starts now, and its imports overlap phase 8, but it touches
    # the card only after phase 8, which times a kernel, and phase 9's
    # profiled round: phases 6 and 7, which read no device time, wait
    # until then, so that the main process has work beside it)
    # step 5 of the scenario process waits for phase 11's prime round
    import multiprocessing

    primed = multiprocessing.get_context("spawn").Event()
    child = start_fleet_child(primed=primed)
    scen = start_scenario_child(primed=primed)
    crash = start_crash_child()

    def open_gates():
        child["gate"].set()
        scen["gate"].set()

    try:
        # ---- 8. the service's tick ----------------------------------------- #
        service = service_phase(torch, np, problems["seed0"], sm_mhz)
        phase_done("phase 8")

        # ---- 9. the sharded plane ------------------------------------------ #
        # (the fleet process touches the card once its profiled round,
        # which reads the device's busy time and idle share, is done)
        log(f"sharded plane on {smi}")
        sharded = sharded_phase(torch, np, problems["seed0"], after_profile=open_gates)
        open_gates()
        phase_done("phase 9")

        # ---- 6. the tick's planning half ----------------------------------- #
        planning_phase(torch, np)
        phase_done("phase 6")

        # ---- 7. the whole tick --------------------------------------------- #
        # (its two solve ticks again on fresh stores with the CPU's store
        # ticked first, a check of the phase times' order, were cut when the
        # loop of phase 8 needed the time: tick_phase(..., card_first=False))
        with untuned_gc():
            tick_launches = tick_phase(torch, np, problems["seed0"], ticks=PHASE7_TICKS)
        phase_done("phase 7")

        # ---- 10. the durable service tick ---------------------------------- #
        log(f"durable tick on {smi}")
        durable = durable_phase(torch, np, problems["seed0"])
        phase_done("phase 10 (the durable tick)")
        fleet = join_fleet_child(child)
        phase_done("the wait for the fleet process")
        # the crash round's children boot on the host beside phases 12
        # and 13, not beside the fleet process's rounds and their solve
        # deadlines
        crash["gate"].set()
        walls.update(fleet["walls"])
        durable["fleet"] = fleet["durable fleet"]
        proc = fleet["fleet"]

        # ---- 12. the job plane and the REST agent surface; 13. the entry - #
        # points (with the scenario process's trace replayed beside 13)
        cron, ingest, rest, cold, smoke, replayed = entry_phases(
            torch, np, problems["seed0"], smi, phase_done, scenarios=scen)
        crashed = join_crash_child(crash)
        phase_done("the wait for the crash process")
        scen["quiet"].set()
        scenarios = join_scenario_child(scen)
        phase_done("the wait for the scenario process")
    finally:
        stop_fleet_child(child)
        stop_fleet_child(scen)
        stop_fleet_child(crash)
        import shutil

        shutil.rmtree(SCENARIO_ROOT, ignore_errors=True)
    walls.update({f"scenario process: {k}": v for k, v in scenarios["walls"].items()})
    walls.update({f"crash process: {k}": v for k, v in crashed["walls"].items()})
    log(f"the crash process's matrices round: card launches {crashed['matrices']}; its net "
        f"round's {crashed['net']}")
    scen_launches = dict(scenarios["launches"])
    add_launches(scen_launches, replayed)
    procs_launches = scenarios["procs"]
    log(f"the scenario process's card launches {scenarios['launches']}, the replay "
        f"process's {replayed}; its proc replays' (step 5: the leader's and every worker "
        f"life's) {procs_launches}")

    # ---- result ------------------------------------------------------------ #
    log("phase walls (s; the fleet process's beside phases 9, 6, 7 and 10): "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    left = live_children()
    check(not left, f"processes this run started are still running: {left}")
    # launches: phase 7's ticks (card first), phase 8's card stores, phase
    # 9's card planes, phase 10's card stores and fleets ("durable"; its
    # in-memory control store (c) apart, as "durable control"), phase
    # 11's process fleet ("fleet": the leader's and every worker's), phase
    # 12's card environment (round 1 as "cron", the ticks after the push as
    # "ingest", the cold tick of the GraphQL round as "cold"), phase 13's
    # service process ("rest"), the smoke process ("smoke"), the scenario
    # process's engine runs and the replay process ("scenarios") and its
    # proc replays ("procs": their leaders' and workers', cold builds), the
    # crash process's children ("crash") and its matrices and net rounds'
    # ("matrices", "net"). The warm
    # card store and plane (b) of phases 8-9, the smoke process's store, and the
    # durable card stores of phases 10, 12 and 13, pack through their
    # resident planes: their fused_distro_stats ran on the slab layout and
    # are the slab row's alone; phase 10's fleet stacks, and phase 11's
    # workers build at the leader's floor (cold builds at the common dims)
    slab_stores = ("a", "replayed")
    paths = {"tick": tick_launches, **service["launches"]}
    for r in rows:
        slab_only = r["name"] == "fused_distro_stats"
        r["launches_by_path"] = {
            p: c[r["name"]] for p, c in paths.items()
            if not (slab_only and p == "card warm")}
        r["launches_by_path"]["sharded"] = sum(
            c[r["name"]] for p, c in sharded.items() if not (slab_only and p == "b"))
        r["launches_by_path"]["durable"] = sum(
            c.get(r["name"], 0) for p, c in durable.items()
            if p != "c" and not (slab_only and p != "fleet"))
        r["launches_by_path"]["durable control"] = (
            0 if slab_only else durable["c"].get(r["name"], 0))
        r["launches_by_path"]["fleet"] = proc.get(r["name"], 0)
        r["launches_by_path"]["loop"] = sum(
            c.get(r["name"], 0) for p, c in service["loop"].items()
            if not (slab_only and p == "card warm"))
        r["launches_by_path"]["cron"] = 0 if slab_only else cron.get(r["name"], 0)
        r["launches_by_path"]["ingest"] = 0 if slab_only else ingest.get(r["name"], 0)
        r["launches_by_path"]["rest"] = 0 if slab_only else rest.get(r["name"], 0)
        r["launches_by_path"]["cold"] = cold.get(r["name"], 0)
        r["launches_by_path"]["smoke"] = 0 if slab_only else smoke.get(r["name"], 0)
        r["launches_by_path"]["scenarios"] = scen_launches.get(r["name"], 0)
        r["launches_by_path"]["procs"] = procs_launches.get(r["name"], 0)
        r["launches_by_path"]["crash"] = crashed["launches"].get(r["name"], 0)
        r["launches_by_path"]["matrices"] = crashed["matrices"].get(r["name"], 0)
        r["launches_by_path"]["net"] = crashed["net"].get(r["name"], 0)
        r["launches"] = sum(r["launches_by_path"].values())
    slab = service["slab_row"]
    slab["floor_ms"] = floor_ms
    slab["launches_by_path"] = {
        "card warm": service["launches"]["card warm"]["fused_distro_stats"],
        "sharded": sharded["b"]["fused_distro_stats"],
        "durable": sum(durable[k].get("fused_distro_stats", 0) for k in slab_stores),
        "durable control": durable["c"].get("fused_distro_stats", 0),
        "fleet": 0,
        "loop": service["loop"]["card warm"].get("fused_distro_stats", 0),
        "cron": cron.get("fused_distro_stats", 0),
        "ingest": ingest.get("fused_distro_stats", 0),
        "rest": rest.get("fused_distro_stats", 0),
        "cold": 0,
        "smoke": smoke.get("fused_distro_stats", 0),
        "scenarios": 0,
        "procs": 0,
        "crash": 0,
        "matrices": 0,
        "net": 0}
    slab["launches"] = sum(slab["launches_by_path"].values())
    rows.append(slab)
    # the byte and chain bounds behind bound_ms are in the log lines above
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "floor_ms",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    code = main()
    # every process the run started has ended (checked above): run
    # multiprocessing's exit finalizers (its semaphores), then skip the
    # interpreter's teardown of the run's heap
    from multiprocessing import util

    util._exit_function()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
