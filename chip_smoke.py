#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mdanalysis_mpi_tpu_torch``) on
one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

That runs every phase.  ``--phases 3,4,13`` runs a comma list of them
instead (phases 1 and 2 always run; every check within a selected phase
stays).  A phase that needs what an earlier phase builds either builds
it itself (the water box of phases 3, 5, 10, 12, 13, 14, 15 and 16; the
config-1 PSF/DCD of phases 13, 15 and 16) or refuses the selection with
a message and exit code 2: phases 6, 8, 9, 10, 12, 14, 15 and 16 run on
phase 4's system and result, so they need 4; phase 5 compares with
phase 3's main case, so it needs 3.
The kernel table line needs phase 3's timings: without phase 3 the
script says so in its place.  A kernel's ``launches`` there is the
count of its whole main path, so it is null unless every phase that
launches it on that path ran (the fused kernel: 4, 8, 14, 15, 16, 9,
10; the pair histogram: 5, 15, 10); the counts of the phases that did
run are printed on a line of their own.  Phase 16's fused launches are
made in its fleet host processes and read from their federated
``mdtpu_fused_blocks_total``; the kernel table labels them
(``fleet_host_launches``).

Phases (each prints its own lines; any failure exits non-zero and
prints no ok line):

1. Device: a CUDA card must be present; prints its name and power limit
   (``nvidia-smi``) and checks that TF32 is off.
2. Build: compiles ``mdanalysis_mpi_tpu_torch/csrc/*.cu`` with nvcc
   into ``build/`` and prints the build seconds and the ptxas report.
3. Kernel against its plain version on the card: the fused
   aligned-moments kernel (``ops/fused_planar.planar_sums``) and
   ``planar_sums_plain`` on the same inputs, at the main path's shape
   (B = 512 frames, S = 50,176 padded atoms) and at small shapes with a
   masked frame tail, padded atoms, int16/int8/float32 planes and a
   per-frame scale.  Holds the moments (mean = Σdev/T within 5e-4, M2
   within 5e-3 — the JAX package's tolerances, tests/test_pallas_fused.py)
   and requires two launches to agree bit for bit; prints the kernel's
   device time per call (``kernel_ms``: the median of its own kernel
   events under ``torch.profiler`` over 20 calls, beside every kernel
   the call launches; a profile must record one event per call of each,
   else it is taken again, up to 5 times), the call's device time with
   the scratch fill
   (``queued_ms``: calls queued behind a sleep, CUDA events around each),
   the wrapper's host wall per call (``call_ms``), the plain version's
   time, the bound, the launches and the largest raw difference of the
   (6, S) sums.
4. End to end at full width: 100,000 atoms (built like bench.py's
   make_system from seed 0), the ``heavy`` selection (50,000 atoms),
   2,048 frames in a MemoryReader, ``batch_size=512``, int16 staging,
   ``AlignedRMSF(engine='fused')`` on ``backend='torch'``.  The kernel's
   launch counter must rise in both passes; a repeat of the run on a
   side CUDA stream must give the same RMSF bit for bit (the staging
   copies follow the caller's stream); the RMSF must agree with
   ``engine=None`` on the card within 5e-4, and over the first 32 frames
   with the serial float64 oracle within 1e-3.  The int8 and delta legs
   are held to 5e-2 against the serial oracle run on the coordinates
   those wire formats deliver (at this system's 100 Å coordinate range
   int8 resolves 0.8 Å, so their error against the raw frames is the
   wire format's, not the kernel's; it is printed, not gated), and to
   the fused-vs-generic tolerances of the JAX package (5e-4 int8, 5e-3
   delta) over all 2,048 frames.
5. InterRDF end to end at full width: BASELINE config 4's O-O g(r) of a
   TIP3P water box, 32,768 waters (98,304 atoms) in a cubic 99.3 Å box
   at water density, 64 frames, ``InterRDF(ow, ow).run(backend='torch',
   device='cuda', batch_size=16)`` with the defaults ``nbins=75,
   range=(0, 15)`` and float32 staging.  The pair-histogram kernel's
   launch counter must rise by 4 (one launch per block); the partials
   stay on the card; a repeat is bit-identical; ``engine='xla'`` (the
   generic torch-op engine) over all 64 frames gives g(r) and every
   bin's count within 1e-5 relative; and on the JAX suite's config-4
   shape (2,000 waters in a 39.1 Å box, 8 frames, ``nbins=75,
   range=(0, 10)``) the kernel route is within 0.05 of the serial
   float64 oracle's g(r) at every bin.  Prints the wall, frames/s,
   pairs/s and the kernel's share of the wall.
6. RMSD and AlignTraj on phase 4's system (built once for both phases):
   ``RMSD(u, select='heavy')`` over all 2,048 frames, batch 512, on
   ``backend='torch', device='cuda'``, at float32 and int16 staging, and
   again with ``groupselections=['name CA', 'name CB']``.  The series
   (``results['rmsd']``, ``results['group_rmsd']``) must be cuda tensors
   of 2,048 rows, a repeat on a side stream bit-identical, and the first
   32 frames within 1e-3 Å of the serial float64 oracle (the JAX suite's
   ``TOL``); the int16 legs are held to the oracle run on the int16
   coordinates against the raw reference frame (at this system's ~90 Å
   range int16 resolves ~0.003 Å, so frame 0 alone sits ~0.0014 Å from
   the raw oracle's 0: the wire format's error, printed, not gated).
   Prints the runtime synchronisations and device-to-host copies
   ``torch.profiler`` records in one Kabsch solve of a block (QCP on the
   device; a batched ``torch.linalg.svd`` made the host wait 3 times)
   and in one whole run.  Then
   ``AlignTraj(u, select='heavy', in_memory=False)`` streams the first
   256 frames (all 100,000 atoms) to a DCD in a temporary directory;
   read back through ``DCDReader``, its ``RMSD(superposition=False)``
   must agree with the fitted float32 series within 1e-3 Å.  AlignTraj
   is cut to 256 frames (307 MB of DCD) to keep the script's time.
7. BASELINE configs 1 and 3 at the JAX suite's sizes
   (benchmarks/suite.py:196-268).  Config 1: ``make_protein_universe(
   n_residues=835, n_frames=98, noise=0.3, seed=1)`` (4,175 atoms)
   written with ``write_psf`` and ``write_dcd``, reopened as
   ``Universe(psf, dcd)``; ``AlignedRMSF(u, select='name CA')`` with
   ``engine=None`` and ``engine='fused'``, int16, batch 32: the fused
   kernel's count must rise in both passes, both routes within 1e-3 Å
   of the serial oracle and within 5e-4 Å of each other.  Config 3:
   ``RMSD`` of the Cα of ``make_protein_universe(500, 256, noise=0.4,
   seed=3)``, batch 64, within 1e-3 Å of the serial oracle.  Prints
   each run's wall and frames/s.
8. Config 2 from an XTC and from an int16 block store (run right after
   phase 4, on its system): the 2,048 frames written as an XTC with
   ``io/writer.TrajectoryWriter`` in 512-frame pieces (box 120 Å),
   ingested with ``io/store.ingest(chunk_frames=512, quant='int16')``
   (one chunk a staged block; no chunk may overflow the store-wide
   scale), both in a temporary directory the phase deletes (it fails if
   fewer than 3 GB are free there).  The XTC leg runs
   ``AlignedRMSF(Universe(top, xtc), select='heavy', engine='fused')``,
   int16, batch 512, and is held to
   the serial float64 oracle on the decoded coordinates over 32 frames
   within 1e-3 Å.  The store leg runs the same from ``Universe(top,
   store_dir)``, then again from a new Universe on a side stream
   (bit-identical): the kernel's count must rise in both passes, the
   store's chunk reads by at least 4, the planar repacks and fused
   blocks must rise, and the reader's float32 decode cache may hold
   chunk 0 (the reference frame) and nothing else; the RMSF must agree
   with ``engine=None`` on the store within 5e-4 Å and, over 32 frames,
   with the serial oracle on the store's coordinates within 1e-3 Å.
   Prints both legs' wall, passes and frames/s, the largest difference
   between the legs (not gated), and the time of one chunk's backend
   read, decode with its CRC checks, gather and planar repack, and
   pinned copy to the card.

14. Config 2 from a GROMACS TRR and from an AMBER PRMTOP + NetCDF (run
   right after phase 8, on phase 4's system and RMSF; the readers and
   writers of ROADMAP A8 item 4).  Phase 4's 2,048 frames are written
   with ``io/writer.TrajectoryWriter`` in 512-frame pieces (box 120 Å)
   as a TRR (about 2.46 GB: float32 nm) and, after that file is run and
   deleted, as a NetCDF (float32 Å); the PRMTOP comes from
   ``io/prmtop.write_prmtop`` of phase 4's universe.  It fails if fewer
   than 2.6 GB of temporary disk are free.  (a) ``Universe(top, trr)``
   and (b) ``Universe(prmtop, nc)`` (whose ``select_atoms('heavy')``
   must give phase 4's 50,000 indices) each run
   ``AlignedRMSF(select='heavy', engine='fused')``, int16, batch 512:
   the kernel's count must rise in both passes; the RMSF must agree
   with ``engine=None`` on the same reader within 5e-4 Å, over 32
   frames with the serial float64 oracle on the decoded coordinates
   within 1e-3 Å, and with phase 4's RMSF within 1e-3 Å (the largest
   difference is printed, and whether it is 0: NetCDF holds float32 Å
   exactly, TRR goes through float32 nm); a repeat from a new Universe
   over the file must be bit-identical.  (c) Phase 13's VelocityAutocorr
   input (256 frames of AR(1) velocities of 98,304 atoms) written with
   ``velocities=`` to a TRR and to a NetCDF (128-frame pieces, about
   0.6 GB each): each file's run within 1e-3 of the largest |C| of the
   in-memory run, its timeseries within 1e-3 relative where |C| >= 1e-2
   C(0), and a repeat bit-identical.  Prints each file's bytes and write
   time, each run's wall, pass split and launches, the host decode of
   one block, and every error beside its limit; the phase's fused
   launches (both legs' first runs) join the kernel table's count.

9. Streaming and several devices (run after phase 6, on phase 4's
   system). (a) Phase 4's main path (fused int16, B = 512 a shard) on
   ``MeshExecutor(devices=None)`` (every visible card) and on
   ``MeshExecutor(devices=['cuda:0'] * 2)`` (a global batch of 1,024
   frames cut into two shards): the fused kernel must launch on every
   shard of every global batch in both passes (printed by device), the
   RMSF within 1e-5 Å (one device) and 5e-4 Å (two shards) of phase 4's
   ``TorchExecutor`` run, and the two-shard run over 32 frames within
   1e-3 Å of the serial float64 oracle on the int16 wire coordinates.
   (b) Two processes (this script with ``--rank``) join a gloo group
   over ``torch.distributed`` (NCCL refuses two ranks on one GPU), each
   stages its half of every 1,024-frame global batch of the heavy atoms
   (saved to a temporary ``.npy``) and runs it through the fused kernel
   on cuda:0; the moments merge by ``all_reduce``. Both ranks must hold
   the same RMSF, within 1e-3 Å of leg (a), with 4 launches each. Then
   one NCCL ``all_reduce`` of leg (a)'s moments at world size 1 must
   equal the merge without the group. (c) ``InterRDF(engine='ring')``
   over two shards of cuda:0, 8,192 waters × 16 frames (phase 5's
   density), against ``engine='xla'`` on the card: counts and g(r)
   within 1e-5 relative. (d) ``run_streaming`` of the fused int16
   AlignedRMSF on a follow store fed by a ``LiveIngest`` thread: 1,024
   of the heavy-atom frames in 256-frame chunks; the snapshots must be
   monotone up to 1,024 frames and the final RMSF within 1e-5 Å of the
   closed-file run over the sealed store. Prints each leg's wall and
   frames/s; the phase's fused launches join the kernel table's count.

10. Dispatch folding, checkpointing and resilient runs (after phase 9,
   on phase 4's system and wire).  (a) The main path, fused int16 at B =
   512, with ``scan_k=1`` and with ``'auto'``, each a first run and
   three repeats over one ``DeviceBlockCache`` (a cached group runs
   eagerly at its first hit, is captured as a CUDA graph at its second
   and replayed from then on): the RMSF must be ``torch.equal`` across
   all eight, each run must launch the fused kernel 8 times, and the
   two captured graphs (one a pass) must each hold 4 fused launches;
   prints each run's wall, pass split and graph captures and replays,
   and the host waits of one replay of each graph (none of its own
   allowed) and of a whole replayed run.  (b) The same at float32 (the
   generic form, Kabsch by QCP on the device) and for the ``RMSD``
   series, with the host waits of a 4-block float32 RMSD run beside the
   batched SVD's 11.  (c) ``InterRDF`` at phase 5's shape with a cache:
   the raw counts ``torch.equal`` across ``scan_k`` settings, 4
   pair-histogram launches a run, and 4 inside the graph.  (d)
   ``run_checkpointed`` of AlignedRMSF in 1,024-frame chunks, crashed
   (an injected ``InjectedCrash`` at the ``kernel`` site) at pass 2's
   second chunk, then resumed: equal to the uninterrupted checkpointed
   run.  (e) ``run(resilient=...)`` with no fault: 8 launches, no
   demotion, the RMSF equal to (a)'s; with 2 injected transient kernel
   faults: retried on the fused rung, 8 launches, equal to (a)'s; an
   injected ``KernelLaunchError`` and an endless kernel fault must
   raise (on the card the chain never leaves the kernel).  (f) The
   same first run over the heavy atoms' first 1,024 frames (saved by
   this phase) in two fresh processes, one cold and
   one after ``warmup_analysis``: the cold run must build (load) the
   kernel library, the warm process's warmup must, and its run must
   not; both RMSF equal.  The phase's launches in the kernel table are
   summed from the counts read around each of its calls, the profiled
   replays included and the fresh processes' left out.

11. Neighbour search and what it unblocks (last; torch ops, neither
   hand kernel may launch).  (a) Config 4's box, one frame
   (``make_water_universe(32768, box=99.3, seed=0)``, 98,304 atoms):
   ``self_capped_distance(all, 3.5, engine='torch')`` on the default
   device (``cuda``), twice (first call and repeat, equal), against
   ``engine='nsgrid'`` on the host: the same pairs in the same order but
   for pairs whose float64 distance lies within 1e-4 Å of a cutoff (the
   float32 class; counted and printed), common distances within 5e-4
   Å; the same for the oxygens against all atoms with
   ``min_cutoff=1.0``.  Prints K, the grid, the capacity, the candidate
   count and the peak device memory.  (b) ``guess_bonds`` on those
   atoms by ``engine='torch'`` and ``'auto'``: equal bonds, two O-H
   bonds inside every water; ``u.bonds.values()`` and, after
   ``guess_angles``, ``u.angles.values()`` against the plain formula on
   the host (1e-9 Å, 1e-6°).  (c) ``HydrogenBondAnalysis`` on its batch
   path: ``make_water_universe(3375, box=46.6, n_frames=256, seed=0)``
   (6,750 H × 3,375 O = 22.8M candidate pairs, the largest box at water
   density under ``MAX_BATCH_PAIRS``), batch 32: a per-block run
   (``scan_k=1``) and three with ``scan_k='auto'`` over one cache (the
   first per block, a repeat eager at the group's first hit, a repeat
   captured as a CUDA graph and replayed), all ``torch.equal``; the
   first 64 frames within 0.1% of each frame's count of
   ``run(backend='serial')``.  Also times the batch function alone on
   one staged block (CUDA events) beside the host's donor guess.  (d) ``LeafletFinder`` of a 48 × 48
   lipid bilayer (4,608 lipids, cutoff 12 Å, PBC) by ``'auto'`` and
   ``'torch'`` (equal groups, two leaflets), ``contact_matrix(...,
   returntype='sparse')`` of (c)'s oxygens at 6 Å against the dense map,
   and ``make_whole`` of (a)'s waters after wrapping them into the box
   (every bond under 2 Å again).  Every leg prints its wall times.

12. The generic analysis API and the analyses of ROADMAP A8 (run after
   phase 10, before phase 7; torch ops, neither hand kernel may
   launch).  (a) On phase 4's system, float32 staging, B = 512:
   ``AnalysisCollection(RMSF(heavy), AverageStructure(u, select='heavy',
   select_only=True))`` and ``AnalysisCollection(RMSD(u, select='heavy'),
   RadiusOfGyration(heavy))``, each against its children run alone
   (with the host stage cache off): every child's partials
   ``torch.equal`` to its solo run's, the collection staging 4 blocks
   where the solo runs stage 8; then a first run and three repeats
   over one ``DeviceBlockCache`` (``scan_k='auto'``), all equal, the
   third replaying a captured graph.  Prints the collection's wall
   against the sum of the solo walls.  (b) Config 1's protein
   (``make_protein_universe(835, 1024, noise=0.3, seed=1)``, 4,175
   atoms): RadiusOfGyration, Ramachandran, HELANAL (Cα) and PCA (Cα,
   ``align=True``, 8 components: a 2,505 × 2,505 covariance) over 1,024
   frames, batch 128; GNM (Cα) and DSSP over 256 frames, batch 32 (and
   the host waits of one GNM run); BAT over 256 frames after
   ``guess_bonds``, on the whole protein if its torsion tree builds,
   else on its largest bonded fragment (printed); Janin of the JAX
   tests' side-chain fixture widened to 64 residues and
   PersistenceLength of their random-walk chains widened to 64 chains of
   16 beads, 256 frames each.  Each run twice (the repeat bit-identical)
   and held to ``backend='serial'`` over its first 64 frames at the JAX
   package's tolerance: PCA variances within 1e-2 of the top variance
   (benchmarks/suite.py:350), GNM eigenvalues within 1e-2 (:402), DSSP
   agreement ≥ 0.98 (:447), the rest at their tests' ``atol``
   (RadiusOfGyration 1e-5 relative, Ramachandran 0.15° and BAT 1e-4
   modulo the period of the angle, HELANAL rises 1e-4 Å and twists 1e-3°
   times sin(twist) — arccos amplifies a float32 cosine's rounding by
   1/sin —, Janin 1e-3°, PersistenceLength 1e-5).  (c) Phase 5's water
   box (32,768 waters, 64 frames, batch 16): EinsteinMSD of the oxygens
   (FFT; 1e-3 relative + 1e-2 of the largest, tests/test_msd.py),
   DensityAnalysis (delta 1 Å: the total exact, the counts equal to the
   host's float32 binning, and the voxels in which they differ from
   the serial float64 oracle's no more than the samples within 1e-4 of
   a voxel edge) and LinearDensity (binsize 0.25 Å, TIP3P charges set
   with ``add_TopologyAttr``: within 5e-2 of the serial oracle,
   suite.py:394), each repeat bit-identical.  Every leg prints its wall
   and frames/s; the phase prints its time.

13. The last A8 analyses, the auxiliary series' reader surface and the
   command line (after phase 12, before phase 7; torch ops, neither
   hand kernel may launch).  (a) ``DistanceMatrix(u, select='name CA')``
   of BASELINE config 1's protein (``make_protein_universe(835, 4096,
   noise=0.3, seed=1)``) at the module's 4,096-frame cap, batch 512:
   a 4,096 × 4,096 matrix, 8.4M distinct Kabsch problems, as row blocks
   of float64 products and the QCP top eigenvalue; the repeat
   bit-identical, the first 128 frames within 5e-3 Å of the serial
   oracle (tests/test_diffusionmap.py), symmetric with a zero diagonal;
   the host waits and device-to-host copies of a run and of its first
   read; then ``DiffusionMap`` of the matrix (host eigh; the top
   eigenvalue 1 within 1e-8, the embedding finite).  (b) ``PSAnalysis``
   of eight 512-frame windows of that Cα trajectory (align=True),
   Hausdorff and discrete Fréchet on the card (28 pairs a metric, one
   batch; the Fréchet recurrence as the anti-diagonal wavefront), each
   repeat bit-identical, pairs (0, 1) and (2, 7) within 0.05 of the
   serial ``hausdorff``/``discrete_frechet`` (tests/test_psa.py), and
   the wavefront EQUAL to the host recurrence on the card's own cross
   matrix of those pairs.  (c) encore on two 256-frame ensembles of
   that trajectory: ``conformational_distance_matrix`` on the card (the
   repeat equal) within 5e-3 Å of the serial Kabsch loop over 64 frames
   of each; ``hes`` finite, non-negative and symmetric (a harmonic
   divergence, not bounded by ln 2), ``ces`` and ``dres`` on the card
   within [0, ln 2].  (d) Phase 5's water box (32,768 waters, 64
   frames, batch 16): ``WaterOrientationalRelaxation`` (dtmax 20; the
   lag sums on the card) and ``AngularDistribution``, each repeat
   bit-identical, against serial over 16 frames within 1e-5 and 1e-4;
   ``DielectricConstant`` with TIP3P charges and ``make_whole=False`` on
   ``TorchExecutor`` and on the mesh over the card, within 1e-3
   relative of serial; ``VelocityAutocorr`` of 256 frames of seeded
   AR(1) velocities (4 Å/ps, 0.9 a frame) of the same 98,304 atoms
   against the float64 ``_np_fft_vacf`` of every 8th atom (1e-3 of the
   largest |C|).  (e) ``python -m mdanalysis_mpi_tpu_torch aligned-rmsf
   TOP TRAJ --output X.npz`` in a subprocess on phase 7's config-1
   PSF/DCD (written again here), its JSON line parsed, the npz's
   ``rmsf`` within 1e-5 Å of the same run in this process.  Every leg
   prints its first-run and repeat walls and its error beside its gate,
   with the card's name and power limit.

15. The serving tier on the card (after phase 5, on phase 4's system
   and phase 5's water box).  (a) One ``service.Scheduler``
   (``n_workers=1``, ``autostart=False``, a shared 16 GiB
   ``DeviceBlockCache``, breakers on, a journal in a temporary
   directory, ``MDTPU_PROF=1``) serves four tenants: A, the fused int16
   ``AlignedRMSF`` of phase 4 (B = 512) on ``backend='torch'``,
   priority 10; B, the same on ``backend='mesh'`` over the one card
   (its own reader of the same frames), priority 5; C, ``RMSD`` and
   ``RadiusOfGyration`` of the heavy atoms (float32), which must
   coalesce into one merged unit; D, ``InterRDF(ow, ow, engine='auto')``
   of the water box, batch 16.  ``Scheduler.warmup`` (programs run for
   the torch and the mesh job), ``prefetch_pending`` (every unit staged,
   none skipped, no "warmup skipped" or failed prefetch logged), then
   the served run with both kernels' counts set to 0 just before and
   read just after: 16 fused and 4 pair-histogram launches, every one
   in a ``mdtpu-serve-*`` worker thread, no cache miss (pass 1 of A
   hits the prefetched blocks), A done before B, nothing shed to serial
   or rerouted, the journal replaying every job as done, the profiler
   holding stacks and no seed alert rule firing over the scheduler's
   snapshot.  Every handle's result is read (a failed job fails the
   phase) and held to a solo ``run()`` on the card, which must carry
   ``results.observability``: RMSF within 1e-5 Å (and whether it is
   bit-equal printed), RMSD, Rg and g(r) within 1e-5 relative, counts
   equal.  (b) Two jobs under an endless injected ``kernel`` fault trip
   the torch breaker (threshold 2); the next torch job fails with
   ``BackendUnavailableError`` naming it and never runs on serial;
   after the cooldown (an injected breaker clock) the half-open probe
   (a torch op on the card and a synchronize) closes the breaker and a
   full AlignedRMSF job runs with 8 fused launches, which join the
   phase's count.  (c) ``python -m mdanalysis_mpi_tpu_torch batch`` on a
   job file of three jobs over config 1's PSF/DCD (AlignedRMSF fused
   int16, RMSD, RadiusOfGyration; Cα, batch 32): every job done, its
   ``.npz`` within 1e-5 Å of the same run in process.  Prints the
   warmup and prefetch seconds, each job's queue wait and latency, the
   served wall beside the solo runs' walls, and every error beside its
   limit.

16. The fleet tier on the card (after phase 15, on phase 4's system and
   phase 5's water box).  Phase 4's heavy atoms (50,000) over its 2,048
   frames become a PSF and an int16 block store of 512-frame chunks,
   and the water box a PSF and a float32 DCD, in a temporary directory.
   (a) ``FleetController(trace=True, device='cuda')`` spawns two
   ``fleet-host`` processes on the card (each with an 8 GiB
   ``DeviceBlockCache`` and ``MDTPU_FLEET_RUN_DELAY=0.5``, which holds
   every received job for half a second) and serves four jobs from the
   files: tenants A and B ``aligned-rmsf`` (fused, int16, batch 512), C
   ``rmsd`` sharded in two chunk-aligned windows, D ``rdf`` of the
   oxygens (75 bins over (0, 15) Å, batch 16, ``engine: pallas``).  The
   host whose received-job instant arrives first is ``kill -9``'d; then
   the fleet drains.  Every job must be done, the journal must hold one
   finish for each host job, one host lost and at least one job
   migrated, each host's federated ``mdtpu_fused_blocks_total`` at
   least 8 per AlignedRMSF job it finished, no serial shed or breaker
   reroute on any host, the merged trace two pids or more with the
   migrated job's trace id on two, and the lost host a flight dump.
   (b) On the same fleet, an ensemble of two InterRDF windows of 32
   frames (``engine: pallas``).  The served results are held to
   in-process runs on the card: A and B within 1e-5 Å of
   ``AlignedRMSF(engine='fused')`` on the store (bit-equality printed),
   C within 1e-5 Å of the unsharded RMSD, D's counts EQUAL to
   ``InterRDF(engine='pallas')``'s and its g(r) within 1e-5 relative,
   the ensemble's count equal to the sum of the two windows' kernel
   counts and its g(r) their frame-weighted mean within 1e-5.  (c)
   ``python -m mdanalysis_mpi_tpu_torch fleet JOBS.json --hosts 2
   --metrics-out FILE`` (no ``--backend``, no ``--device``) on config
   1's PSF/DCD: AlignedRMSF fused int16, RMSD and RadiusOfGyration of
   the Cα, batch 32, each with an ``output``; its hosts' fused blocks at
   least 8 and no serial shed, each ``.npz`` within 1e-5 of the run in
   this process.  Prints the hosts' spawn-to-join seconds,
   ``nvidia-smi``'s compute apps of the hosts before the kill and after
   the drain, each host job's host, latency, migrations and completion
   resends before the ack, the per-host fused blocks, the completion
   JSON's bytes and encode time, and the wave and phase walls.

Phase 3 also holds the pair-histogram kernel (``ops/fused_distances.
pair_histogram``, ``csrc/pair_histogram.cu``) against
``pair_histogram_plain`` on the card: the main shape (the first block of
phase 5's run: 16 frames of 32,768 × 32,768 oxygens, 75 bins over
(0, 15) Å, ``exclude_self``), the same block binned over (0, 1) Å where
no pair falls (the distance arithmetic alone), the same block unwrapped
(every atom shifted by a whole multiple of L in [-1, 1] per axis, so
most pairs take the kernel's division branch), the same block with the
atoms within 2 Å of the lower y face moved to their image just above L
and those within 2 Å of the upper z face to their image just below 0
(no B atom then lies within reach of an A atom at |d| >= L, so every
pair keeps the division-free form; these three timed like the main
case), a ragged 300 × 515 case, a case without a box, 1 bin, 512 bins,
a batch with a masked frame and a batch with a triclinic frame (which
must come out NaN).  Every case's counts must EQUAL the plain
version's (``torch.equal``: 0 bins differing; the kernel's rewrites are
exact), two launches must be bit-identical, and no bin of a block may
reach 2^24 (where float32 counts stop being exact).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published rates of the card (NVIDIA data sheets): memory bytes/s and
# float32 (non-tensor-core) flop/s, keyed by a substring of the name.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),          # H100 SXM5 (80GB HBM3)
    ("H200", 4.8e12, 67e12),
)
# Work of the fused function per atom-frame: dequant 3, COM 6,
# correlation 18, centre 3, rotate 15, deviation + masks 9, sums 9;
# per frame: the QCP solve (~40 Newton steps + adjugate, ~1000 flops).
FLOPS_PER_ATOM_FRAME = 63
FLOPS_PER_FRAME = 1000

# Phase 4: BASELINE config 2 at full width (100k atoms, 50k heavy,
# batch 512); its 10,000 frames cut to 2,048 to fit the time limit.
E2E_ATOMS = 100_000
E2E_FRAMES = 2048
E2E_BATCH = 512

KERNEL_NAME = "fused_aligned_moments"
KERNEL_SYMBOL = "fused_planar_kernel"      # its CUDA kernel's name
KERNEL_SOURCE = "mdanalysis_mpi_tpu_torch/csrc/fused_rmsf.cu"
KERNEL_REPLACES = "mdanalysis_mpi_tpu/ops/pallas_fused.py:289"

# Phase 5: BASELINE config 4 (InterRDF O-O, TIP3P water box) at 32,768
# waters, the 100k-atom size of config 2, in a box at water density
# (0.0334 waters/Å^3); 64 frames, batch 16.  The oracle check runs at
# the JAX suite's config-4 shape (benchmarks/suite.py:273: 2,000 waters,
# 8 frames, range (0, 10)) but in a box at water density, 39.1 Å.
RDF_WATERS = 32768
RDF_BOX = 99.3
RDF_FRAMES = 64
RDF_BATCH = 16
ORACLE_WATERS = 2000
ORACLE_BOX = 39.1
ORACLE_FRAMES = 8
# Work of the pair-histogram function as the TPU kernel computes it
# (pallas_distances.py), the yardstick kept whatever implements it.
# Every pair: per axis sub, div, rint, mul, sub, square (18), two adds,
# sqrt, the two range compares = 23.  Every pair inside the range, in
# addition: sub, mul, floor, two clamps and two edge compares = 7.  At
# the float32 FMA rate these give an optimistic bound: the CUDA kernel
# issues no FMA in its pair loop.
FLOPS_PER_PAIR = 23
FLOPS_PER_BINNED_PAIR = 7
# Phase 6: RMSD on phase 4's system; AlignTraj streams 256 of its
# 2,048 frames (all 100,000 atoms, 1.2 MB a frame) to a DCD.
RMSD_GROUPS = ["name CA", "name CB"]
ALIGN_FRAMES = 256
# Phase 8: phase 4's system written as an XTC (in bench.py's 120 Å flagship
# box) and ingested into an int16 block store of 512-frame chunks (one
# chunk a staged block): about 1.1 GB of XTC and 1.23 GB of store in a
# temporary directory.
STORE_BOX = np.array([120.0, 120.0, 120.0, 90.0, 90.0, 90.0])
STORE_DISK_BYTES = 3_000_000_000
# Phase 14: phase 4's system as a GROMACS TRR and as an AMBER PRMTOP +
# NetCDF (each ~2.46 GB of float32 frames in a 120 Å box, written, run
# and deleted one after the other), then phase 13's VACF input as a TRR
# and a NetCDF with velocities (~0.6 GB each), in a temporary directory.
FILES_DISK_BYTES = 2_600_000_000
VACF_CHUNK = 128
# Phase 9: the mesh executor, two ranks, the ring RDF and streaming.
# The ring runs a quarter of phase 5's box (8,192 waters at the same
# density: 99.3 / 4^(1/3) Å); streaming ingests 1,024 of phase 4's
# frames (the heavy atoms) in 256-frame chunks.
RING_WATERS = 8192
RING_BOX = 62.56
RING_FRAMES = 16
STREAM_FRAMES = 1024
STREAM_CHUNK = 256
RANK_TIMEOUT_S = 240
# Phase 11: neighbour search.  The cell list at phase 5's width
# (BASELINE config 4's water box, one frame); HydrogenBondAnalysis on
# its batch path at the largest water box under the JAX package's
# MAX_BATCH_PAIRS (3,375 waters at water density: 6,750 H x 3,375 O =
# 22.8M candidate pairs), 256 frames, batch 32; a bilayer of 48 x 48
# lipids a leaflet.  NS_DEVICE None is the port's default device.
NS_CUTOFF = 3.5
NS_MIN_CUTOFF = 1.0
NS_EDGE = 1e-4
NS_DIST_TOL = 5e-4
HB_WATERS = 3375
HB_BOX = 46.6
HB_FRAMES = 256
HB_BATCH = 32
HB_SERIAL_FRAMES = 64
HB_REL_TOL = 1e-3
LEAFLET_SIDE = 48
NS_DEVICE = None
PH_NAME = "pair_histogram"
PH_SOURCE = "mdanalysis_mpi_tpu_torch/csrc/pair_histogram.cu"
PH_REPLACES = "mdanalysis_mpi_tpu/ops/pallas_distances.py:164"

# phase 12: the generic analysis API and the analyses of ROADMAP A8 (the
# analyses are torch ops; neither hand kernel may launch)
AN_DEVICE = "cuda"
AN_RESIDUES = 835                    # BASELINE config 1's protein
AN_FRAMES = 1024
AN_SHORT = 256                       # GNM, DSSP, BAT, Janin, polymer
AN_ORACLE = 64                       # frames held to the serial oracle
AN_BATCH = 128
AN_SHORT_BATCH = 32
JANIN_RESIDUES = 64
POLY_CHAINS = 64
POLY_BEADS = 16
DENSITY_DELTA = 1.0
LINDENS_BINSIZE = 0.25
TIP3P_CHARGES = (-0.834, 0.417, 0.417)
# phase 13: the last A8 analyses at BASELINE config 1's width
DM_FRAMES = 4096                     # DistanceMatrix's frame cap
DM_BATCH = 512
DM_ORACLE = 128                      # frames held to the serial loop
DM_TOL = 5e-3                        # the JAX package's parity gate, A
DM_F64_TOL = 1e-8                    # the float64 route against float64, A
PSA_PATHS = 8
PSA_FRAMES = 512
PSA_PAIRS = ((0, 1), (2, 7))         # pairs held to the serial metrics
ENC_FRAMES = 256
ENC_ORACLE = 64                      # frames of each ensemble held to serial
WATER_ORACLE = 16
WOR_DTMAX = 20
VACF_FRAMES = 256
VACF_STRIDE = 8                      # the float64 oracle's particles
VACF_RTOL = 1e-3                     # test_vacf.py's elementwise rtol
VACF_FLOOR = 1e-2                    # lags held to it: |C| >= this x C(0)
CLI_TOL = 1e-5
# every phase, in the order they run
PHASE_ORDER = (1, 2, 3, 4, 8, 14, 5, 15, 16, 6, 9, 10, 12, 13, 7, 11)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    print(f"note: no published rates for {name!r}; using the H100 SXM's")
    return CARD_RATES[2][1], CARD_RATES[2][2]


# ---------------------------------------------------------------- phase 1

def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    import mdanalysis_mpi_tpu_torch.device  # noqa: F401  (sets TF32 off)

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul is on")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN is on")
    print("tf32: off (matmul, cudnn)")
    return card


# ---------------------------------------------------------------- phase 2

def phase_build():
    from mdanalysis_mpi_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS:.2f} s) -> {_build.library_path()}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line or line.startswith("=="):
            print(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------- phase 3

def _rotations(rng, n):
    a = rng.normal(size=(n, 3, 3))
    u, _, vt = np.linalg.svd(a)
    d = np.sign(np.linalg.det(u @ vt))
    u[:, :, -1] *= d[:, None]
    return u @ vt


def make_case(B, n_real, dtype, valid, seed, per_frame=False):
    """Staged planes + fused params on the card, like the main path's:
    a centred reference of coordinate scale 20 Å, each frame a rigid
    rotation + translation of it plus 0.3 Å noise, quantized."""
    import torch

    from mdanalysis_mpi_tpu_torch.io.base import planar_repack
    from mdanalysis_mpi_tpu_torch.ops import fused_rmsf as fr
    from mdanalysis_mpi_tpu_torch.staging import quantize_block

    rng = np.random.default_rng(seed)
    idx_p, nr = fr.pad_selection(np.arange(n_real))
    S = len(idx_p)
    ref = rng.normal(scale=20.0, size=(n_real, 3)).astype(np.float32)
    masses = rng.uniform(1, 16, size=n_real)
    com = (ref * (masses / masses.sum())[:, None]).sum(0)
    refc = ref - com
    rots = _rotations(rng, B).astype(np.float32)
    coords = np.einsum("ni,bji->bnj", ref, rots)
    coords += rng.normal(scale=10.0, size=(B, 1, 3)).astype(np.float32)
    coords += rng.normal(scale=0.3, size=coords.shape).astype(np.float32)
    coords = coords[:, idx_p].astype(np.float32)
    if dtype == "float32":
        qp, inv = np.ascontiguousarray(np.moveaxis(coords, 2, 0)), 1.0
    else:
        q, inv = quantize_block(coords, dtype)
        qp, inv = planar_repack(q), float(inv)
    dev = torch.device("cuda")
    params = fr.build_params(refc, com, masses, nr, S)
    wN, refc_p, _, amask, sref = (p.to(dev) for p in params)
    fmask = np.zeros(B, np.float32)
    fmask[:valid] = 1.0
    inv_arg = (torch.full((B,), inv, dtype=torch.float32, device=dev)
               if per_frame else inv)
    return (torch.from_numpy(qp).to(dev), inv_arg, wN, refc_p, amask, sref,
            torch.from_numpy(fmask).to(dev))


def time_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


SLEEP_CYCLES = 60_000_000   # ~30 ms at ~2 GHz: longer than any enqueue
PROFILE_REPS = 20
PROFILE_TRIES = 5


def short_name(kernel):
    """``void (anonymous namespace)::fused_planar_kernel<short>(...)`` →
    ``fused_planar_kernel``."""
    import re

    m = re.search(r"(\w+)\s*[<(]",
                  kernel.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else kernel


def profiler_ms(fn, reps):
    """Device time of each CUDA kernel ``fn`` launches in ``reps``
    calls, from ``torch.profiler`` kernel events (memsets and fills
    included) → {short name: (median ms per event, events recorded)}.

    The profile opens with one marker kernel (``torch.cuda._sleep``,
    ``spin_kernel``), left out of the result: on the H100 the profiler
    missed the first kernel of a profile in some profiles (19 of 20
    events of the first kernel of the call, every other kernel 20)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = collections.defaultdict(list)
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            times[short_name(e.name)].append(e.time_range.elapsed_us() / 1e3)
    return {n: (statistics.median(t), len(t)) for n, t in times.items()
            if "spin" not in n and "sleep" not in n}


def kernel_split(fn, reps=PROFILE_REPS):
    """:func:`profiler_ms` with every kernel's event count held to
    ``reps``: the profiler can miss an event, and a profile that did is
    taken again, up to ``PROFILE_TRIES`` times, before the check fails."""
    for _ in range(PROFILE_TRIES):
        split = profiler_ms(fn, reps)
        if split and all(n == reps for _, n in split.values()):
            return split
        counts = {k: n for k, (_, n) in split.items()}
        print(f"note: the profile recorded {counts} kernel events of "
              f"{reps} calls; profiling again")
    raise SmokeFailure(f"the profiler recorded {counts} kernel events of "
                       f"{reps} calls in each of {PROFILE_TRIES} profiles")


def fused_timing(args):
    """Device and host time of one ``planar_sums`` call on ``args`` →
    (kernel split as :func:`kernel_split`, queued device ms of the call,
    largest gap between queued calls, host wall ms per call)."""
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    def call():
        return fp.planar_sums(*args)

    call()
    split = kernel_split(call)
    q_ms, _, _, gap = queued_ms(call, PROFILE_REPS)
    return split, q_ms, gap, call_ms(call, PROFILE_REPS)


def split_text(split):
    return ", ".join(f"{n} {ms:.4f} ({k})" for n, (ms, k) in
                     sorted(split.items(), key=lambda kv: -kv[1][0]))


def queued_ms(fn, reps):
    """Per-call device ms of ``fn`` run back to back behind a sleep, CUDA
    events around each call alone → (median, least, greatest, largest
    gap between one call's end and the next one's start)."""
    import torch

    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in ev]
    gaps = [ev[i][1].elapsed_time(ev[i + 1][0]) for i in range(reps - 1)]
    return (statistics.median(times), min(times), max(times),
            max(gaps, default=0.0))


def call_ms(fn, reps):
    """Host wall ms per call of ``fn`` (no synchronise inside)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def bound_ms(args, bw, flops):
    qp, inv, wN, refc_p, amask, sref, fmask = args
    _, B, S = qp.shape
    nbytes = (qp.numel() * qp.element_size()
              + sum(t.numel() * 4 for t in (wN, refc_p, amask, sref, fmask))
              + (B * 4 if hasattr(inv, "numel") else 0)
              + 6 * S * 4)
    ops = FLOPS_PER_ATOM_FRAME * B * S + FLOPS_PER_FRAME * B
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(card_name):
    import torch

    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    bw, flops = card_rates(card_name)
    cases = [
        ("main-int16", 512, 50000, "int16", 512, False),
        ("main-int8", 512, 50000, "int8", 512, False),
        ("main-f32", 512, 50000, "float32", 512, False),
        ("tail-int16", 56, 3000, "int16", 50, False),
        ("tail-int8", 56, 3000, "int8", 50, False),
        ("pad-f32", 56, 200, "float32", 56, False),
        ("perframe-int16", 16, 100, "int16", 16, True),
        ("pad-int16-B1", 1, 300, "int16", 1, False),
    ]
    rows = {}
    worst = 0.0
    for name, B, n_real, dtype, valid, per_frame in cases:
        args = make_case(B, n_real, dtype, valid, seed=B + n_real,
                         per_frame=per_frame)
        qp = args[0]
        l0 = fp.planar_sums.launches
        out1 = fp.planar_sums(*args)
        out2 = fp.planar_sums(*args)
        torch.cuda.synchronize()
        plain = fp.planar_sums_plain(*args)
        torch.cuda.synchronize()
        check(torch.isfinite(out1).all().item(), f"{name}: non-finite output")
        check(torch.equal(out1, out2),
              f"{name}: two launches differ (not deterministic)")
        T = args[6].sum()
        raw = (out1 - plain).abs().max().item()
        mean_err = ((out1[:3] - plain[:3]) / T).abs().max().item()
        m2 = out1[3:] - out1[:3] ** 2 / T
        m2_plain = plain[3:] - plain[:3] ** 2 / T
        m2_err = (m2 - m2_plain).abs().max().item()
        check(mean_err <= 5e-4, f"{name}: mean differs by {mean_err:.3g}")
        check(m2_err <= 5e-3, f"{name}: M2 differs by {m2_err:.3g}")
        launches = fp.planar_sums.launches - l0
        split, q_ms, gap, c_ms = fused_timing(args)
        check(KERNEL_SYMBOL in split, f"{name}: no {KERNEL_SYMBOL} kernel "
              f"event in the profile ({sorted(split)})")
        k_ms = split[KERNEL_SYMBOL][0]
        p_ms = time_ms(lambda: fp.planar_sums_plain(*args), 5)
        b_ms, b_by = bound_ms(args, bw, flops)
        worst = max(worst, raw)
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=raw)
        print(f"kernel {name}: B={B} S={qp.shape[2]} {dtype} valid={valid} "
              f"kernel_ms={k_ms:.4f} queued_ms={q_ms:.4f} "
              f"(gap {gap:.4f}) call_ms={c_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) launches={launches} "
              f"raw_max_abs={raw:.3g} mean_err={mean_err:.3g} "
              f"m2_err={m2_err:.3g} bit_identical=True; device ms "
              f"(events): {split_text(split)}")
        del args, out1, out2, plain
    return rows, worst


def event_ms(fn):
    """One call of ``fn`` timed by CUDA events → (its result, ms)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def make_water(n_waters, box, n_frames):
    """The config-4 system from seed 0 and its oxygens."""
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=n_waters, box=box, n_frames=n_frames,
                            seed=0)
    return u, u.select_atoms("name OW")


def ph_bound_ms(a, b, nbins, counts, bw, flops):
    """Bound of one pair-histogram call: the coordinates, box lengths
    and edges read once and the uint64 counts written once, against the
    operations of every pair plus those of the pairs this run's data put
    inside the range (``counts.sum()``)."""
    B, N, _ = a.shape
    M = b.shape[1]
    nbytes = (B * N + B * M) * 3 * 4 + B * 3 * 4 + (nbins + 1) * 4 \
        + B * nbins * 8
    binned = float(np.nansum(counts))
    ops = FLOPS_PER_PAIR * B * N * M + FLOPS_PER_BINNED_PAIR * binned
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_equal(name, got, want):
    """The kernel's counts must equal the plain version's → the number
    of bins that differ (0)."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{name}: non-finite counts")
    n_diff = int((got != want).sum())
    check(torch.equal(got, want),
          f"{name}: {n_diff} bins differ from the plain version (totals "
          f"{float(got.sum()):.0f} vs {float(want.sum()):.0f})")
    return n_diff


def phase_pair_histogram(card_name, ow):
    """Phase 3, pair-histogram kernel: each case against its plain
    version on the card → (rows by case, largest |kernel − plain|)."""
    import torch

    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd

    bw, flops = card_rates(card_name)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def rand(B, n, scale):
        return torch.from_numpy(rng.uniform(
            0, scale, size=(B, n, 3)).astype(np.float32)).to(dev)

    def lin(lo, hi, nbins):
        return torch.from_numpy(
            np.linspace(lo, hi, nbins + 1).astype(np.float32)).to(dev)

    def boxes(B, L, angles=(90.0, 90.0, 90.0)):
        row = np.array([L, L, L, *angles], np.float32)
        return torch.from_numpy(np.tile(row, (B, 1))).to(dev)

    block, _ = ow.universe.trajectory.read_block(0, RDF_BATCH,
                                                 sel=ow.indices)
    main = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    L = np.float32(RDF_BOX)
    shifts = np.random.default_rng(4).integers(-1, 2, block.shape)
    unwrapped = torch.from_numpy(np.ascontiguousarray(
        block + L * shifts.astype(np.float32))).to(dev)
    outside = block.copy()
    outside[..., 1] = np.where(block[..., 1] < 2, block[..., 1] + L,
                               block[..., 1])
    outside[..., 2] = np.where(block[..., 2] > L - 2, block[..., 2] - L,
                               block[..., 2])
    outside = torch.from_numpy(outside).to(dev)
    small = rand(2, 150, 25.0)
    tric = boxes(3, 25.0)
    tric[1, 3] = 80.0
    # name: (a, b, boxes (B, 6) or None, edges, exclude_self, mask)
    cases = {
        "main": (main, main, boxes(RDF_BATCH, RDF_BOX), lin(0, 15, 75),
                 True, None),
        # the main block binned over (0, 1) Å, where no two oxygens of
        # the lattice lie: every pair's distance is computed, none is
        # binned, so this reads the arithmetic without the atomics
        "main-unbinned": (main, main, boxes(RDF_BATCH, RDF_BOX),
                          lin(0, 1, 75), True, None),
        # the main block with coordinates in [-L, 2L): most pairs have
        # |d| >= L on some axis and take the division branch
        "main-unwrapped": (unwrapped, unwrapped, boxes(RDF_BATCH, RDF_BOX),
                           lin(0, 15, 75), True, None),
        # the main block with ~6% of its atoms moved to their image just
        # outside the box (within 2 Å), in every tile, as whole
        # molecules leave them: still the division-free form throughout
        "main-outliers": (outside, outside, boxes(RDF_BATCH, RDF_BOX),
                          lin(0, 15, 75), True, None),
        "ragged-300x515": (rand(2, 300, 25.0), rand(2, 515, 25.0),
                           boxes(2, 25.0), lin(0, 12, 48), False, None),
        "no-box": (rand(2, 200, 25.0), rand(2, 333, 25.0), boxes(2, 0.0),
                   lin(0, 12, 48), False, None),
        "1-bin": (small, small, boxes(2, 25.0), lin(0, 12, 1), True, None),
        "512-bins": (small, small, boxes(2, 25.0), lin(0, 12, 512), True,
                     None),
        "masked-frame": (rand(3, 120, 25.0), rand(3, 80, 25.0),
                         boxes(3, 25.0), lin(0, 12, 48), False,
                         torch.tensor([1.0, 1.0, 0.0], device=dev)),
        "triclinic-frame": (rand(3, 120, 25.0), rand(3, 80, 25.0), tric,
                            lin(0, 12, 48), False,
                            torch.ones(3, device=dev)),
    }
    rows, worst = {}, 0.0
    for name, (a, b, bx, edges, excl, mask) in cases.items():
        nbins = edges.shape[0] - 1
        lengths = bx[:, :3].contiguous()
        l0 = fd.pair_histogram.launches

        def kernel():
            if mask is None:
                return fd.pair_histogram(a, b, box=bx, exclude_self=excl,
                                         edges=edges)
            return fd.pair_histogram_batch(a, b, bx, mask, edges,
                                           exclude_self=excl)[0]

        out1, out2 = kernel(), kernel()
        plain, p_ms = event_ms(lambda: fd.pair_histogram_plain(
            a, b, lengths, edges, excl))
        launches = fd.pair_histogram.launches - l0
        check(torch.equal(out1, out2) or (torch.isnan(out1).all()
                                          and torch.isnan(out2).all()),
              f"{name}: two launches differ (not deterministic)")
        if name == "triclinic-frame":
            check(torch.isnan(out1).all().item(),
                  f"{name}: the triclinic frame did not come out NaN")
            # the orthorhombic frames, launched alone, still agree
            sub = [0, 2]
            got = fd.pair_histogram(a[sub], b[sub], box=bx[sub],
                                    edges=edges)
            want = plain[sub]
        elif mask is not None:
            got, want = out1, mask @ plain
        else:
            got, want = out1, plain
        block = want.sum(0) if want.dim() == 2 else want
        check(bool((block.max() < 2 ** 24).item()),
              f"{name}: a bin of the block reached 2^24 counts; float32 "
              "is not exact there")
        n_diff = check_equal(name, got, want)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        big = name.startswith("main")
        k_ms = time_ms(kernel, 5 if big else 20)
        if not big:
            p_ms = time_ms(lambda: fd.pair_histogram_plain(
                a, b, lengths, edges, excl), 5)
        b_ms, b_by = ph_bound_ms(a, b, nbins, plain.cpu().numpy(), bw, flops)
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err)
        print(f"pair_histogram {name}: B={a.shape[0]} N={a.shape[1]} "
              f"M={b.shape[1]} nbins={nbins} exclude_self={excl} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) launches={launches} "
              f"bins_differing={n_diff} max_abs={err:.3g} "
              f"max_block_bin={float(block.max()):.0f} bit_identical=True")
    return rows, worst


# ---------------------------------------------------------------- phase 4

def make_system(n_atoms, n_frames, seed=0):
    """bench.py's make_system: residues of (CA, CB, HA, HB) — half heavy
    — with a 20 Å random base, each frame a small rigid rotation about z
    plus 0.3 Å noise, filled in 500-frame chunks."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    rng = np.random.default_rng(seed)
    base = rng.normal(scale=20.0, size=(n_atoms, 3)).astype(np.float32)
    base -= base.mean(axis=0)
    frames = np.empty((n_frames, n_atoms, 3), dtype=np.float32)
    for lo in range(0, n_frames, 500):
        hi = min(lo + 500, n_frames)
        angles = rng.normal(scale=0.1, size=hi - lo)
        cos, sin = np.cos(angles), np.sin(angles)
        rots = np.zeros((hi - lo, 3, 3), dtype=np.float32)
        rots[:, 0, 0] = cos
        rots[:, 0, 1] = -sin
        rots[:, 1, 0] = sin
        rots[:, 1, 1] = cos
        rots[:, 2, 2] = 1.0
        chunk = np.einsum("ni,fij->fnj", base, rots)
        chunk += rng.normal(scale=0.3, size=chunk.shape).astype(np.float32)
        frames[lo:hi] = chunk
    n_res = n_atoms // 4
    names = np.tile(np.array(["CA", "CB", "HA", "HB"]), n_res + 1)[:n_atoms]
    top = Topology(names=names, resnames=np.full(n_atoms, "ALA"),
                   resids=np.arange(n_atoms) // 4 + 1)
    return Universe(top, MemoryReader(frames))


def heavy_universe(coords):
    """A universe holding only the given heavy-atom coordinates
    ((F, n, 3), CA/CB alternating, the selection's order and masses)."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    n = coords.shape[1]
    names = np.tile(np.array(["CA", "CB"]), n // 2 + 1)[:n]
    top = Topology(names=names, resnames=np.full(n, "ALA"),
                   resids=np.arange(n) // 2 + 1)
    return Universe(top, MemoryReader(np.ascontiguousarray(coords)))


def wire_frames(u, sel_p, n_sel, n_frames, bs, wire):
    """The first ``n_frames`` frames of the selection as the int8 or
    delta wire delivers them to the device (the executor's staging:
    one block padded to ``bs`` frames)."""
    from mdanalysis_mpi_tpu_torch.parallel.partition import pad_batch
    from mdanalysis_mpi_tpu_torch.staging import (quantize_block,
                                                  quantize_block_delta)

    block, _ = u.trajectory.read_block(0, n_frames, sel=sel_p)
    if wire == "int8":
        q, inv = quantize_block(block, "int8")
        x = q.astype(np.float32) * inv
    else:
        padded, _ = pad_batch(block, bs)
        res, key, inv_abs, inv_res = quantize_block_delta(
            padded, 1, n_valid=n_frames)
        x = (key.astype(np.float32) * inv_abs
             + np.cumsum(res.astype(np.float32) * inv_res, axis=0))
    return x[:n_frames, :n_sel]


def fused_passes(run):
    """``run()`` (an ``AlignedRMSF.run``) with the fused kernel's count
    set to 0 just before and read just after, and read again between
    the passes → (analysis, wall s, pass-1 wall s, pass-1 launches,
    launches)."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    seen = {}
    make_pass2 = AlignedRMSF._make_pass2

    def _mark_pass1(self, avg):
        seen["launches"] = fp.planar_sums.launches
        seen["t"] = time.perf_counter()
        return make_pass2(self, avg)

    AlignedRMSF._make_pass2 = _mark_pass1
    try:
        torch.cuda.synchronize()
        fp.planar_sums.launches = 0
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fp.planar_sums.launches
    finally:
        AlignedRMSF._make_pass2 = make_pass2
    return (r, wall, seen.get("t", t0) - t0, seen.get("launches", 0),
            launches)


def e2e_main_runs(card):
    """Phase 4's main path: the system, one fused int16 AlignedRMSF run
    and its repeat on a side stream (bit-identical) → (universe,
    selection indices, RMSF, the runs' walls and launches)."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import pad_selection

    n_atoms, n_frames, bs = E2E_ATOMS, E2E_FRAMES, E2E_BATCH
    sel = "heavy"
    run_kw = dict(backend="torch", batch_size=bs, device="cuda")
    t0 = time.perf_counter()
    u = make_system(n_atoms, n_frames, seed=0)
    idx = u.select_atoms(sel).indices
    check(len(idx) == n_atoms // 2, f"heavy selection has {len(idx)} atoms")
    print(f"e2e: system {n_atoms} atoms x {n_frames} frames, selection "
          f"{len(idx)} atoms (S={len(pad_selection(idx)[0])}), built in "
          f"{time.perf_counter() - t0:.1f} s")

    def main_path(stream=None):
        """One fused int16 run on ``stream`` (None = the current one)."""
        with torch.cuda.stream(stream):
            return fused_passes(lambda: AlignedRMSF(
                u, select=sel, engine="fused").run(transfer_dtype="int16",
                                                   **run_kw))

    fused, wall, t_pass1, pass1, launches = main_path()
    pass2 = launches - pass1
    check(pass1 > 0 and pass2 > 0,
          f"kernel launches per pass: pass1={pass1} pass2={pass2}")
    raw_rmsf = fused.results["rmsf"]
    check(isinstance(raw_rmsf, torch.Tensor)
          and raw_rmsf.device.type == "cuda",
          "results['rmsf'] is not a tensor on the card")
    rmsf = fused.results.rmsf
    check(rmsf.shape == (len(idx),) and np.isfinite(rmsf).all(),
          f"fused RMSF shape {rmsf.shape} / non-finite values")
    # pass 1 stages every block on the host; pass 2 reads them from the
    # device block cache, so its wall is the device side and launches
    print(f"e2e main path: AlignedRMSF(engine='fused') int16 B={bs}: "
          f"wall {wall:.3f} s, {n_frames / wall:.1f} frames/s (both passes, "
          f"host staging included; pass 1 {t_pass1:.3f} s, pass 2 "
          f"{wall - t_pass1:.3f} s), launches pass1={pass1} pass2={pass2} "
          f"on {card}")

    # the readers' adaptive int16 scale hints would stage the repeat's
    # first block with another scale; start it from the same state
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    again, wall2, t2_pass1, _, _ = main_path(torch.cuda.Stream())
    check(np.array_equal(rmsf, again.results.rmsf),
          "fused RMSF on a side stream not bit-identical to the first run")
    print(f"e2e repeat on a side stream: wall {wall2:.3f} s, "
          f"{n_frames / wall2:.1f} frames/s (pass 1 {t2_pass1:.3f} s, "
          f"pass 2 {wall2 - t2_pass1:.3f} s), bit-identical to the first "
          f"run")
    runs = dict(launches=launches, pass1_launches=pass1, wall=wall,
                pass1=t_pass1, pass2=wall - t_pass1, repeat_wall=wall2,
                repeat_pass1=t2_pass1, repeat_pass2=wall2 - t2_pass1,
                frames=n_frames)
    return u, idx, rmsf, runs


def phase_end_to_end(card):
    """Phase 4: config 2 of the reference at full width, 2,048 frames."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import pad_selection

    u, idx, rmsf, runs = e2e_main_runs(card)
    n_frames, bs = E2E_FRAMES, E2E_BATCH
    n32, sel = 32, "heavy"
    run_kw = dict(backend="torch", batch_size=bs, device="cuda")
    generic = AlignedRMSF(u, select=sel).run(
        transfer_dtype="int16", **run_kw)
    err = np.abs(rmsf - generic.results.rmsf).max()
    print(f"e2e fused vs engine=None (int16, {n_frames} frames): "
          f"max |d rmsf| = {err:.3g} (limit 5e-4)")
    check(err <= 5e-4, f"fused vs generic RMSF differ by {err:.3g}")

    oracle = AlignedRMSF(u, select=sel).run(stop=n32, backend="serial")
    f32run = AlignedRMSF(u, select=sel, engine="fused").run(
        stop=n32, transfer_dtype="int16", **run_kw)
    err = np.abs(f32run.results.rmsf - oracle.results.rmsf).max()
    print(f"e2e fused int16 vs serial f64 oracle ({n32} frames): "
          f"max |d rmsf| = {err:.3g} (limit 1e-3)")
    check(err <= 1e-3, f"fused int16 vs oracle differ by {err:.3g}")

    sel_p = pad_selection(idx)[0]
    for wire, tol_generic in (("int8", 5e-4), ("delta", 5e-3)):
        f_all = AlignedRMSF(u, select=sel, engine="fused").run(
            transfer_dtype=wire, **run_kw)
        g_all = AlignedRMSF(u, select=sel).run(transfer_dtype=wire, **run_kw)
        err_g = np.abs(f_all.results.rmsf - g_all.results.rmsf).max()
        f_32 = AlignedRMSF(u, select=sel, engine="fused").run(
            stop=n32, transfer_dtype=wire, **run_kw)
        u_wire = heavy_universe(wire_frames(u, sel_p, len(idx), n32, bs,
                                            wire))
        o_wire = AlignedRMSF(u_wire, select="heavy").run(backend="serial")
        err_o = np.abs(f_32.results.rmsf - o_wire.results.rmsf).max()
        err_raw = np.abs(f_32.results.rmsf - oracle.results.rmsf).max()
        print(f"e2e {wire}: fused vs engine=None ({n_frames} frames) "
              f"{err_g:.3g} (limit {tol_generic:g}); fused vs serial oracle "
              f"on the {wire} coordinates ({n32} frames) {err_o:.3g} "
              f"(limit 5e-2); vs the raw-frame oracle {err_raw:.3g} "
              f"(not gated)")
        check(err_g <= tol_generic,
              f"{wire}: fused vs generic differ by {err_g:.3g}")
        check(err_o <= 5e-2, f"{wire}: fused vs oracle differ by {err_o:.3g}")
    return runs["launches"], u, rmsf


# ---------------------------------------------------------------- phase 5

def phase_rdf(card, u, ow, main_row):
    """Phase 5: InterRDF of config 4 at full width → its launches."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd

    run_kw = dict(backend="torch", device="cuda", batch_size=RDF_BATCH)
    n = ow.n_atoms
    check(n == RDF_WATERS and u.trajectory.n_frames == RDF_FRAMES,
          f"water system has {n} oxygens, {u.trajectory.n_frames} frames")
    pairs = RDF_FRAMES * n * (n - 1)

    def main_path():
        """One run with the kernel's count set to 0 just before and read
        just after → (analysis, wall s, launches)."""
        torch.cuda.synchronize()
        fd.pair_histogram.launches = 0
        t0 = time.perf_counter()
        r = InterRDF(ow, ow).run(**run_kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, fd.pair_histogram.launches

    first, wall1, launches = main_path()
    n_blocks = -(-RDF_FRAMES // RDF_BATCH)
    check(launches == n_blocks,
          f"pair-histogram launches {launches}, expected {n_blocks}")
    check(first._resolved_engine == "pallas",
          f"'auto' resolved to {first._resolved_engine!r} on the card")
    raw = first._last_total[0]
    check(isinstance(raw, torch.Tensor) and raw.device.type == "cuda",
          "the count partials are not a tensor on the card")
    count, rdf = first.results.count, first.results.rdf
    check(count.shape == (75,) and rdf.shape == (75,)
          and np.isfinite(rdf).all() and count.sum() > 0,
          f"InterRDF result shape {count.shape} / non-finite values")
    again, wall2, launches2 = main_path()
    check(launches2 == n_blocks, f"repeat launched {launches2} times")
    check(np.array_equal(count, again.results.count)
          and np.array_equal(rdf, again.results.rdf),
          "InterRDF repeat not bit-identical")
    share = main_row["ms"] * n_blocks / 1e3 / wall2
    print(f"rdf main path: InterRDF(ow, ow) {n} oxygens x {RDF_FRAMES} "
          f"frames, batch {RDF_BATCH}, nbins 75, range (0, 15): launches "
          f"{launches}; first run wall {wall1:.3f} s ({RDF_FRAMES / wall1:.1f} "
          f"frames/s, {pairs / wall1:.4g} pairs/s); repeat wall "
          f"{wall2:.3f} s ({RDF_FRAMES / wall2:.1f} frames/s, "
          f"{pairs / wall2:.4g} pairs/s), bit-identical; kernel share of "
          f"the repeat's wall {100 * share:.1f}% ({n_blocks} x "
          f"{main_row['ms']:.3f} ms) on {card}; g(r) peak "
          f"{rdf.max():.3f} at r = {first.results.bins[rdf.argmax()]:.2f} A")

    t0 = time.perf_counter()
    xla = InterRDF(ow, ow, engine="xla").run(**run_kw)
    x_count, x_rdf = xla.results.count, xla.results.rdf
    t_xla = time.perf_counter() - t0
    c_rel = np.abs(count - x_count) / np.maximum(np.abs(x_count), 1e-30)
    r_rel = np.abs(rdf - x_rdf) / np.maximum(np.abs(x_rdf), 1e-30)
    print(f"rdf kernel vs engine='xla' on the card (all {RDF_FRAMES} frames, "
          f"xla wall {t_xla:.3f} s): max rel d count {c_rel.max():.3g}, "
          f"max rel d g(r) {r_rel.max():.3g} (limit 1e-5 each), "
          f"{int((count != x_count).sum())} bins differ")
    check(c_rel.max() <= 1e-5 and r_rel.max() <= 1e-5,
          "kernel route vs engine='xla' outside 1e-5")

    uo, owo = make_water(ORACLE_WATERS, ORACLE_BOX, ORACLE_FRAMES)
    kw = dict(nbins=75, range=(0.0, 10.0))
    oracle = InterRDF(owo, owo, **kw).run(backend="serial")
    fd.pair_histogram.launches = 0
    kern = InterRDF(owo, owo, **kw).run(backend="torch", device="cuda",
                                        batch_size=RDF_BATCH)
    check(fd.pair_histogram.launches > 0,
          "the oracle-shape run did not launch the kernel")
    d_g = np.abs(kern.results.rdf - oracle.results.rdf).max()
    d_c = kern.results.count - oracle.results.count
    print(f"rdf kernel vs serial float64 oracle ({ORACLE_WATERS} waters, "
          f"{ORACLE_BOX} A box, {ORACLE_FRAMES} frames, nbins 75, range "
          f"(0, 10)): max |d g(r)| {d_g:.3g} (limit 0.05); counts: "
          f"{int((d_c != 0).sum())} bins differ, max |d| "
          f"{np.abs(d_c).max():.0f}, total {kern.results.count.sum():.0f} "
          f"vs {oracle.results.count.sum():.0f}")
    check(d_g < 0.05, f"kernel route vs oracle: max |d g(r)| = {d_g:.3g}")
    return launches


# ---------------------------------------------------------------- phase 6

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def host_syncs(fn):
    """``fn()`` under ``torch.profiler`` → (its result, {runtime call
    that makes the host wait for the card: count}, the number of
    device→host copies).  The counts include the profile's own closing
    ``torch.cuda.synchronize()`` (one ``cudaDeviceSynchronize``)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    waits = collections.Counter(n for n in names if n in SYNC_CALLS)
    dtoh = sum(n.startswith("Memcpy DtoH") for n in names)
    return out, dict(waits), dtoh


def timed(fn):
    """``fn()`` between two ``torch.cuda.synchronize()`` → (result,
    wall s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_rmsd(card, u):
    """Phase 6: the RMSD series and AlignTraj on phase 4's system."""
    import tempfile

    import torch

    from mdanalysis_mpi_tpu_torch.analysis import RMSD, AlignTraj
    from mdanalysis_mpi_tpu_torch.io.dcd import DCDReader
    from mdanalysis_mpi_tpu_torch.ops.align import kabsch_from_correlation

    n_frames, bs, n32, sel = E2E_FRAMES, E2E_BATCH, 32, "heavy"
    run_kw = dict(backend="torch", device="cuda", batch_size=bs)
    n_blocks = -(-n_frames // bs)
    idx = u.select_atoms(sel).indices
    # the int16 leg's oracle runs on the coordinates that wire delivers
    # (the first block as the run stages it, exact scale) against the
    # raw reference frame: at this system's ~90 A coordinate range int16
    # resolves ~0.003 A, so frame 0 alone sits ~0.0014 A from the raw
    # oracle's 0, the wire format's error and not the port's
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    q, _, inv = u.trajectory.stage_block(0, bs, idx, "int16")
    raw32 = u.trajectory.read_block(0, n32, sel=idx)[0]
    u_raw = heavy_universe(raw32)
    u_wire = heavy_universe(q[:n32].astype(np.float32) * np.float32(inv))
    fitted = None
    for groups in (None, RMSD_GROUPS):
        label = "groups" if groups else "main"
        oracle = RMSD(u, select=sel, groupselections=groups).run(
            stop=n32, backend="serial")
        oracle16 = RMSD(u_wire, reference=u_raw, select=sel,
                        groupselections=groups).run(backend="serial")
        for dtype in ("float32", "int16"):
            def run():
                return RMSD(u, select=sel, groupselections=groups).run(
                    transfer_dtype=dtype, **run_kw)

            # start every run's int16 scale hints from the same state
            u.trajectory.__dict__.pop("_quant_max_hints", None)
            r, wall = timed(run)
            raw = r.results["rmsd"]
            check(isinstance(raw, torch.Tensor) and raw.device.type == "cuda"
                  and raw.shape == (n_frames,),
                  f"rmsd {label} {dtype}: results['rmsd'] is not a cuda "
                  f"tensor of {n_frames} values")
            u.trajectory.__dict__.pop("_quant_max_hints", None)
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                again, wall2 = timed(run)
            keys = ("rmsd", "group_rmsd") if groups else ("rmsd",)
            for key in keys:
                check(torch.equal(r.results[key], again.results[key]),
                      f"rmsd {label} {dtype}: {key} on a side stream not "
                      "bit-identical")
            gate = oracle16 if dtype == "int16" else oracle
            errs, raw_errs = [], []
            for key in keys:
                got = getattr(r.results, key)
                check(np.isfinite(got).all(),
                      f"rmsd {label} {dtype}: non-finite {key}")
                errs.append(float(np.abs(
                    got[:n32] - getattr(gate.results, key)).max()))
                raw_errs.append(float(np.abs(
                    got[:n32] - getattr(oracle.results, key)).max()))
            wire = " on the int16 coordinates" if dtype == "int16" else ""
            print(f"rmsd {label}: RMSD(select='heavy'"
                  f"{', groupselections=' + str(groups) if groups else ''})"
                  f" {len(idx)} atoms x {n_frames} frames, {dtype}, batch "
                  f"{bs}: wall {wall:.3f} s ({n_frames / wall:.1f} "
                  f"frames/s), side-stream repeat {wall2:.3f} s "
                  f"({n_frames / wall2:.1f} frames/s), bit-identical; vs "
                  f"serial oracle{wire} ({n32} frames) max |d| "
                  f"{', '.join(f'{e:.3g}' for e in errs)} (limit 1e-3); vs "
                  f"the raw-frame oracle "
                  f"{', '.join(f'{e:.3g}' for e in raw_errs)}"
                  f"{' (not gated)' if wire else ''} on {card}")
            check(max(errs) <= 1e-3,
                  f"rmsd {label} {dtype}: {max(errs):.3g} from the oracle")
            if groups is None and dtype == "float32":
                fitted = r.results.rmsd

    # does the Kabsch solve make the host wait?  One solve on a block's
    # worth of 3x3 matrices, then a whole float32 run
    h = torch.randn(bs, 3, 3, device="cuda")
    kabsch_from_correlation(h)
    _, svd_waits, svd_dtoh = host_syncs(lambda: kabsch_from_correlation(h))
    _, run_waits, run_dtoh = host_syncs(lambda: RMSD(u, select=sel).run(
        transfer_dtype="float32", **run_kw))
    print(f"rmsd host syncs (each profile's closing synchronize "
          f"included): one Kabsch solve (QCP) of "
          f"({bs}, 3, 3) on the card: waits {svd_waits}, {svd_dtoh} "
          f"device-to-host copies; a whole float32 RMSD run ({n_blocks} "
          f"blocks): waits {run_waits}, {run_dtoh} device-to-host copies")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.dcd")
        at, wall = timed(lambda: AlignTraj(
            u, select=sel, in_memory=False, filename=path).run(
                stop=ALIGN_FRAMES, device="cuda"))
        check(at.results.filename == path, "AlignTraj wrote elsewhere")
        mb = os.path.getsize(path) / 2 ** 20
        uw = at.results.universe
        check(isinstance(uw.trajectory, DCDReader)
              and uw.trajectory.n_frames == ALIGN_FRAMES
              and uw.trajectory.n_atoms == u.atoms.n_atoms,
              "the streamed DCD does not read back as "
              f"{ALIGN_FRAMES} frames x {u.atoms.n_atoms} atoms")
        back, wall_b = timed(lambda: RMSD(
            uw, select=sel, superposition=False).run(**run_kw))
        err = float(np.abs(back.results.rmsd - fitted[:ALIGN_FRAMES]).max())
        print(f"aligntraj: AlignTraj(select='heavy', in_memory=False) "
              f"{u.atoms.n_atoms} atoms x {ALIGN_FRAMES} frames, batch 64, "
              f"to a {mb:.1f} MiB DCD: wall {wall:.3f} s "
              f"({ALIGN_FRAMES / wall:.1f} frames/s); read back through "
              f"DCDReader, RMSD(superposition=False) {wall_b:.3f} s; vs the "
              f"fitted float32 series max |d| {err:.3g} (limit 1e-3)")
        check(err <= 1e-3,
              f"AlignTraj's DCD reads back {err:.3g} from the fitted RMSD")
        uw.trajectory.close()


# ---------------------------------------------------------------- phase 7

def write_config1(tmp):
    """BASELINE config 1 as files in ``tmp``: the JAX suite's protein
    (benchmarks/suite.py:196: 3341 // 4 = 835 residues of 5 atoms,
    4,175 atoms, 98 frames) → (psf path, dcd path, atoms)."""
    from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd
    from mdanalysis_mpi_tpu_torch.io.psf import write_psf
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    u0 = make_protein_universe(n_residues=835, n_frames=98, noise=0.3, seed=1)
    psf, dcd = os.path.join(tmp, "adk.psf"), os.path.join(tmp, "adk.dcd")
    write_psf(psf, u0.topology)
    write_dcd(dcd, u0.trajectory.read_block(0, 98)[0])
    return psf, dcd, u0.atoms.n_atoms


def phase_configs(card):
    """Phase 7: BASELINE configs 1 and 3 at their published sizes →
    the fused kernel's launches in config 1's run (pass 1, pass 2)."""
    import tempfile

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import RMSD, AlignedRMSF
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    run_kw = dict(backend="torch", device="cuda", batch_size=32,
                  transfer_dtype="int16")
    with tempfile.TemporaryDirectory() as tmp:
        psf, dcd, n_atoms = write_config1(tmp)
        u = Universe(psf, dcd)
        ca = u.select_atoms("name CA")
        check(ca.n_atoms == 835 and u.trajectory.n_frames == 98,
              f"config 1 reopened as {ca.n_atoms} CA x "
              f"{u.trajectory.n_frames} frames")
        oracle = AlignedRMSF(u, select="name CA").run(
            backend="serial").results.rmsf
        generic, g_wall = timed(lambda: AlignedRMSF(
            u, select="name CA").run(**run_kw))
        fused, f_wall, _, pass1, launches = fused_passes(
            lambda: AlignedRMSF(u, select="name CA", engine="fused").run(
                **run_kw))
        pass2 = launches - pass1
        check(pass1 > 0 and pass2 > 0,
              f"config 1 fused launches: pass1={pass1} pass2={pass2}")
        e_g = float(np.abs(generic.results.rmsf - oracle).max())
        e_f = float(np.abs(fused.results.rmsf - oracle).max())
        e_fg = float(np.abs(fused.results.rmsf
                            - generic.results.rmsf).max())
        print(f"config 1: AlignedRMSF(select='name CA') 835 CA of "
              f"{n_atoms} atoms x 98 frames from PSF/DCD, int16, batch 32: "
              f"engine=None wall {g_wall:.3f} s ({98 / g_wall:.1f} "
              f"frames/s), engine='fused' wall {f_wall:.3f} s "
              f"({98 / f_wall:.1f} frames/s), fused launches pass1={pass1} "
              f"pass2={pass2}; vs serial oracle max |d rmsf| generic "
              f"{e_g:.3g}, fused {e_f:.3g} (limit 1e-3); fused vs generic "
              f"{e_fg:.3g} (limit 5e-4) on {card}")
        check(e_g <= 1e-3 and e_f <= 1e-3,
              f"config 1 vs oracle: generic {e_g:.3g}, fused {e_f:.3g}")
        check(e_fg <= 5e-4, f"config 1 fused vs generic {e_fg:.3g}")
        u.trajectory.close()

    u3 = make_protein_universe(n_residues=500, n_frames=256, noise=0.4,
                               seed=3)
    ca3 = u3.select_atoms("name CA")
    r3, wall3 = timed(lambda: RMSD(ca3).run(backend="torch", device="cuda",
                                            batch_size=64))
    o3 = RMSD(ca3).run(backend="serial").results.rmsd
    e3 = float(np.abs(r3.results.rmsd - o3).max())
    print(f"config 3: RMSD(select CA) 500 atoms x 256 frames, batch 64: "
          f"wall {wall3:.3f} s ({256 / wall3:.1f} frames/s); vs serial "
          f"oracle max |d| {e3:.3g} (limit 1e-3) on {card}")
    check(r3.results.rmsd.shape == (256,) and e3 <= 1e-3,
          f"config 3 vs oracle {e3:.3g}")
    return pass1, pass2


# ---------------------------------------------------------------- phase 8

def metric(name):
    """The sum of a counter's series on the port's ``obs.METRICS``."""
    from mdanalysis_mpi_tpu_torch import obs

    return sum(obs.METRICS.snapshot().get(
        name, {"values": {}})["values"].values())


def write_pieces(path, u, n_frames, chunk):
    """The universe's frames (box 120 Å) through the port's
    ``TrajectoryWriter``, ``chunk`` frames a write → seconds."""
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

    t0 = time.perf_counter()
    with TrajectoryWriter(path) as w:
        for lo in range(0, n_frames, chunk):
            frames, _ = u.trajectory.read_block(lo, min(lo + chunk,
                                                        n_frames))
            w.write(frames, dimensions=STORE_BOX)
    return time.perf_counter() - t0


def leg_text(n_frames, wall, t_pass1, pass1, launches):
    return (f"wall {wall:.3f} s, {n_frames / wall:.1f} frames/s (pass 1 "
            f"{t_pass1:.3f} s, pass 2 {wall - t_pass1:.3f} s), launches "
            f"pass1={pass1} pass2={launches - pass1}")


def store_split(card, store, sel_p, bs):
    """Where pass 1's time goes from the store, on chunk 1 of the store
    (one staged block): the backend read, the decode with its CRC
    checks, the gather and planar repack of ``_stage_direct`` (chunk
    already decoded), and the pinned host-to-device copy.  Three
    repetitions each, in that order; the chunk comes from the page
    cache (the store was just written)."""
    import torch

    from mdanalysis_mpi_tpu_torch.io.store import StoreReader, codec

    sr = StoreReader(store)
    ci = 1
    entry = sr._entries[ci]
    lo, hi = entry["start"], entry["stop"]
    dev = torch.device("cuda")
    times = {k: [] for k in ("get_bytes", "decode_chunk", "stage_direct",
                             "pin", "h2d")}
    for _ in range(3):
        t0 = time.perf_counter()
        blob = sr._backend.get_bytes(entry["file"])
        t1 = time.perf_counter()
        codec.decode_chunk(blob, path=sr._chunk_path(ci),
                           expect_fps=entry.get("fps"))
        t2 = time.perf_counter()
        sr._load_raw(ci)
        t3 = time.perf_counter()
        q, _, _ = sr._stage_direct(lo, hi, sel_p, layout="planar")
        t4 = time.perf_counter()
        pinned = torch.from_numpy(q).pin_memory()
        t5 = time.perf_counter()
        on_card = pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for k, v in (("get_bytes", t1 - t0), ("decode_chunk", t2 - t1),
                     ("stage_direct", t4 - t3), ("pin", t5 - t4),
                     ("h2d", t6 - t5)):
            times[k].append(v)
        del on_card, pinned
    check(q.shape == (3, hi - lo, len(sel_p)) and q.dtype == np.int16,
          f"store split staged {q.shape} {q.dtype}")
    text = ", ".join(f"{k} " + "/".join(f"{v * 1e3:.1f}" for v in vs)
                     for k, vs in times.items())
    print(f"store split of one chunk ({hi - lo} frames, {len(blob)} bytes "
          f"read, {q.nbytes} bytes staged as (3, {hi - lo}, {len(sel_p)}) "
          f"int16), ms for 3 repetitions: {text} on {card}")
    return {k: min(vs) for k, vs in times.items()}


def phase_store(card, u):
    """Phase 8: config 2 from an XTC and from an int16 block store → the
    fused kernel's launches in the XTC leg's run and the store leg's
    first run."""
    import shutil
    import tempfile

    import torch

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.io.store import ingest
    from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import pad_selection

    t_phase = time.perf_counter()
    n_frames, bs, n32, sel = E2E_FRAMES, E2E_BATCH, 32, "heavy"
    run_kw = dict(backend="torch", device="cuda", batch_size=bs,
                  transfer_dtype="int16")
    top = u.topology
    n_sel = len(u.select_atoms(sel).indices)
    sel_p = pad_selection(u.select_atoms(sel).indices)[0]
    tmp = tempfile.mkdtemp(prefix="mdtpu_store_")
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= STORE_DISK_BYTES,
              f"phase 8 needs {STORE_DISK_BYTES / 1e9:.1f} GB of temporary "
              f"disk at {tmp}; {free / 1e9:.1f} GB free")
        xtc = os.path.join(tmp, "config2.xtc")
        wall_w = write_pieces(xtc, u, n_frames, bs)
        print(f"store xtc: {n_frames} frames x {u.atoms.n_atoms} atoms "
              f"written with TrajectoryWriter in {bs}-frame pieces: "
              f"{wall_w:.2f} s, {os.path.getsize(xtc)} bytes")
        store = os.path.join(tmp, "config2.store")
        summary = ingest(xtc, store, chunk_frames=bs, quant="int16")
        print(f"store ingest: wall_s {summary['wall_s']}, store_ingest_fps "
              f"{summary['store_ingest_fps']}, bytes {summary['bytes']}, "
              f"chunks {summary['n_chunks']}, scale_overflow_chunks "
              f"{summary['scale_overflow_chunks']}")
        check(summary["n_chunks"] == -(-n_frames // bs),
              f"ingest made {summary['n_chunks']} chunks")
        check(summary["scale_overflow_chunks"] == 0,
              f"{summary['scale_overflow_chunks']} chunks overflowed the "
              "store-wide scale; the raw-slice path was not measured")

        # the XTC decode leg: every pass-1 block decoded and quantized
        # on the host (one adaptive scale per block)
        u_xtc = Universe(top, xtc)
        fx, wall, t1, p1, lx = fused_passes(lambda: AlignedRMSF(
            u_xtc, select=sel, engine="fused").run(**run_kw))
        check(p1 > 0 and lx - p1 > 0,
              f"xtc leg launches: pass1={p1} pass2={lx - p1}")
        rmsf_x = fx.results.rmsf
        check(rmsf_x.shape == (n_sel,) and np.isfinite(rmsf_x).all(),
              f"xtc leg RMSF shape {rmsf_x.shape} / non-finite values")
        # the timed run itself, against the plain engine on the same
        # XTC and the same per-block wire
        generic_x = AlignedRMSF(u_xtc, select=sel).run(**run_kw)
        err_gx = float(np.abs(rmsf_x - generic_x.results.rmsf).max())
        oracle_x = AlignedRMSF(u_xtc, select=sel).run(stop=n32,
                                                      backend="serial")
        f32_x = AlignedRMSF(u_xtc, select=sel, engine="fused").run(
            stop=n32, **run_kw)
        err_x = float(np.abs(f32_x.results.rmsf
                             - oracle_x.results.rmsf).max())
        print(f"store xtc leg: AlignedRMSF(Universe(top, xtc), "
              f"engine='fused') int16 B={bs}: "
              f"{leg_text(n_frames, wall, t1, p1, lx)}; vs engine=None on "
              f"the XTC ({n_frames} frames) {err_gx:.3g} (limit 5e-4); vs "
              f"serial oracle on the decoded coordinates ({n32} frames) "
              f"{err_x:.3g} (limit 1e-3) on {card}")
        check(err_gx <= 5e-4, f"xtc fused vs generic {err_gx:.3g}")
        check(err_x <= 1e-3, f"xtc leg vs oracle {err_x:.3g}")
        u_xtc.trajectory.close()
        del u_xtc, fx, f32_x, generic_x

        # the store leg: int16 chunk slices staged planar, no host f32
        counters = ("mdtpu_store_chunks_read_total",
                    "mdtpu_fused_planar_repacks_total",
                    "mdtpu_fused_blocks_total")

        def store_run(stream=None):
            us = Universe(top, store)
            before = {k: metric(k) for k in counters}
            with torch.cuda.stream(stream):
                out = fused_passes(lambda: AlignedRMSF(
                    us, select=sel, engine="fused").run(**run_kw))
            grew = {k: metric(k) - before[k] for k in counters}
            f32 = sorted(us.trajectory._f32)
            return out, grew, f32

        (fs, wall, t1, p1, ls), grew, f32 = store_run()
        check(p1 > 0 and ls - p1 > 0,
              f"store leg launches: pass1={p1} pass2={ls - p1}")
        check(grew["mdtpu_store_chunks_read_total"] >= -(-n_frames // bs),
              f"store leg read {grew['mdtpu_store_chunks_read_total']} "
              "chunks")
        check(grew["mdtpu_fused_planar_repacks_total"] > 0
              and grew["mdtpu_fused_blocks_total"] > 0,
              f"store leg counters did not rise: {grew}")
        check(set(f32) <= {0},
              f"staged blocks decoded host f32 chunks {f32}")
        rmsf_s = fs.results.rmsf
        check(np.isfinite(rmsf_s).all(), "store leg RMSF not finite")
        print(f"store leg: AlignedRMSF(Universe(top, store_dir), "
              f"engine='fused') int16 B={bs}: "
              f"{leg_text(n_frames, wall, t1, p1, ls)}; counters "
              + ", ".join(f"{k} +{v:g}" for k, v in grew.items())
              + f"; f32 chunks decoded {f32} on {card}")
        del fs
        (again, wall2, t2, p2, l2), _, f32b = store_run(torch.cuda.Stream())
        check(np.array_equal(rmsf_s, again.results.rmsf),
              "store leg repeat not bit-identical to the first run")
        check(set(f32b) <= {0}, f"repeat decoded host f32 chunks {f32b}")
        print(f"store leg repeat (a new Universe on a side stream): "
              f"{leg_text(n_frames, wall2, t2, p2, l2)}; bit-identical")
        del again

        generic = AlignedRMSF(Universe(top, store), select=sel).run(**run_kw)
        err_g = float(np.abs(rmsf_s - generic.results.rmsf).max())
        oracle_s = AlignedRMSF(Universe(top, store), select=sel).run(
            stop=n32, backend="serial")
        f32_s = AlignedRMSF(Universe(top, store), select=sel,
                            engine="fused").run(stop=n32, **run_kw)
        err_o = float(np.abs(f32_s.results.rmsf
                             - oracle_s.results.rmsf).max())
        err_sx = float(np.abs(rmsf_s - rmsf_x).max())
        print(f"store leg: fused vs engine=None on the store "
              f"({n_frames} frames) {err_g:.3g} (limit 5e-4); vs serial "
              f"oracle on the store's coordinates ({n32} frames) "
              f"{err_o:.3g} (limit 1e-3); store leg vs xtc leg "
              f"{err_sx:.3g} (limit 1e-3: both are int16 wires of the same "
              f"frames, one store-wide scale against one adaptive scale per "
              f"block)")
        check(err_g <= 5e-4, f"store fused vs generic {err_g:.3g}")
        check(err_o <= 1e-3, f"store fused vs oracle {err_o:.3g}")
        check(err_sx <= 1e-3, f"store leg vs xtc leg {err_sx:.3g}")
        store_split(card, store, sel_p, bs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"store phase: {time.perf_counter() - t_phase:.1f} s")
    return lx + ls


# ---------------------------------------------------------------- phase 14

def file_rmsf_leg(card, label, open_universe, idx, rmsf_e2e):
    """Phase 14 (a) or (b): config 2's fused int16 AlignedRMSF from the
    universe ``open_universe()`` opens over a file, held to phase 8's
    gates and to phase 4's RMSF, then again from a new Universe over
    the same file (bit-identical) → (launches of the first run, its
    largest difference from phase 4)."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import pad_selection

    n_frames, bs, n32, sel = E2E_FRAMES, E2E_BATCH, 32, "heavy"
    run_kw = dict(backend="torch", device="cuda", batch_size=bs,
                  transfer_dtype="int16")
    t0 = time.perf_counter()
    uf = open_universe()
    t_open = time.perf_counter() - t0
    got = uf.select_atoms(sel).indices
    check(np.array_equal(got, idx),
          f"{label}: select_atoms('heavy') gives {len(got)} atoms, not "
          f"phase 4's {len(idx)}")
    fx, wall, t1, p1, lx = fused_passes(lambda: AlignedRMSF(
        uf, select=sel, engine="fused").run(**run_kw))
    check(p1 > 0 and lx - p1 > 0,
          f"{label} launches: pass1={p1} pass2={lx - p1}")
    rmsf = fx.results.rmsf
    check(rmsf.shape == (len(idx),) and np.isfinite(rmsf).all(),
          f"{label} RMSF shape {rmsf.shape} / non-finite values")
    generic = AlignedRMSF(uf, select=sel).run(**run_kw)
    err_g = float(np.abs(rmsf - generic.results.rmsf).max())
    oracle = AlignedRMSF(uf, select=sel).run(stop=n32, backend="serial")
    f32 = AlignedRMSF(uf, select=sel, engine="fused").run(stop=n32,
                                                          **run_kw)
    err_o = float(np.abs(f32.results.rmsf - oracle.results.rmsf).max())
    err_4 = float(np.abs(rmsf - rmsf_e2e).max())
    # one 512-frame block's host decode alone (the reader's read_block)
    sel_p = pad_selection(idx)[0]
    t0 = time.perf_counter()
    uf.trajectory.read_block(bs, 2 * bs, sel=sel_p)
    t_block = time.perf_counter() - t0
    uf.trajectory.close()
    del uf, fx, generic, f32
    print(f"files {label}: AlignedRMSF(engine='fused') int16 B={bs}: "
          f"{leg_text(n_frames, wall, t1, p1, lx)}; opened in "
          f"{t_open:.2f} s; host decode of one {bs}-frame block "
          f"{t_block:.3f} s; vs engine=None on the file ({n_frames} "
          f"frames) {err_g:.3g} (limit 5e-4); vs serial oracle on the "
          f"decoded coordinates ({n32} frames) {err_o:.3g} (limit 1e-3); "
          f"vs phase 4's RMSF {err_4:.3g} (limit 1e-3; exactly 0: "
          f"{err_4 == 0.0}) on {card}")
    check(err_g <= 5e-4, f"{label} fused vs generic {err_g:.3g}")
    check(err_o <= 1e-3, f"{label} vs oracle {err_o:.3g}")
    check(err_4 <= 1e-3, f"{label} vs phase 4 {err_4:.3g}")
    again, wall2, t2, p2, l2 = fused_passes(lambda: AlignedRMSF(
        open_universe(), select=sel, engine="fused").run(**run_kw))
    check(np.array_equal(rmsf, again.results.rmsf),
          f"{label} repeat on a new Universe not bit-identical")
    check(p2 > 0 and l2 - p2 > 0,
          f"{label} repeat launches: pass1={p2} pass2={l2 - p2}")
    print(f"files {label} repeat (a new Universe over the file): "
          f"{leg_text(n_frames, wall2, t2, p2, l2)}; bit-identical")
    return lx, err_4


def vacf_file_legs(card, uw, tmp):
    """Phase 14 (c): phase 13's VACF input written with velocities to a
    TRR and to a NetCDF (``TrajectoryWriter``, VACF_CHUNK frames a
    write), each run against the in-memory run under phase 13's
    gates."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import VelocityAutocorr
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

    n_at = uw.atoms.n_atoms
    vel = ar1_velocities(n_at)
    zeros = np.zeros((VACF_FRAMES, n_at, 3), np.float32)

    def run(open_universe):
        r = VelocityAutocorr(open_universe().atoms).run(backend="torch",
                                                        device="cuda")
        return np.asarray(r.results.vacf_by_particle)

    want, wall_m = timed(lambda: run(lambda: Universe(
        uw.topology, MemoryReader(zeros, velocities=vel))))
    ts_want = want.mean(axis=1)
    lags = np.abs(ts_want) >= VACF_FLOOR * abs(ts_want[0])
    for ext in ("trr", "nc"):
        path = os.path.join(tmp, f"vacf.{ext}")
        t0 = time.perf_counter()
        with TrajectoryWriter(path) as w:
            for lo in range(0, VACF_FRAMES, VACF_CHUNK):
                w.write(zeros[lo:lo + VACF_CHUNK],
                        velocities=vel[lo:lo + VACF_CHUNK])
        t_w = time.perf_counter() - t0
        size = os.path.getsize(path)
        by, wall = timed(lambda: run(lambda: Universe(uw.topology, path)))
        by2, wall2 = timed(lambda: run(lambda: Universe(uw.topology,
                                                        path)))
        check(same(by, by2), f"VACF from {ext}: repeat not bit-identical")
        err = float(np.abs(by - want).max() / np.abs(want).max())
        ts_got = by.mean(axis=1)
        rel = float((np.abs(ts_got - ts_want)[lags]
                     / np.abs(ts_want[lags])).max())
        os.remove(path)
        print(f"files (c) VelocityAutocorr from {ext}: {n_at} atoms x "
              f"{VACF_FRAMES} frames, {size} bytes written in {t_w:.2f} "
              f"s; wall {wall:.3f} s (host frame reads included; the "
              f"in-memory run {wall_m:.3f} s), repeat {wall2:.3f} s "
              f"bit-identical; vs the in-memory run: max |d| / max |C| "
              f"{err:.3g} (limit 1e-3), timeseries over the "
              f"{int(lags.sum())} of {lags.size} lags with |C| >= "
              f"{VACF_FLOOR} C(0): max relative |d| {rel:.3g} (limit "
              f"{VACF_RTOL}) on {card}")
        check(err <= 1e-3, f"VACF from {ext}: {err:.3g} of the largest "
              "|C| against the in-memory run (limit 1e-3)")
        check(rel <= VACF_RTOL, f"VACF from {ext}: timeseries {rel:.3g} "
              f"relative to the in-memory run (limit {VACF_RTOL})")


def phase_files(card, u, rmsf_e2e, uw):
    """Phase 14: config 2 from a GROMACS TRR and from an AMBER PRMTOP +
    NetCDF, and VelocityAutocorr from both formats → the fused kernel's
    launches in the two legs' first runs."""
    import shutil
    import tempfile

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.io.prmtop import write_prmtop

    t_phase = time.perf_counter()
    n_frames, bs = E2E_FRAMES, E2E_BATCH
    top = u.topology
    idx = u.select_atoms("heavy").indices
    launches = 0
    tmp = tempfile.mkdtemp(prefix="mdtpu_files_")
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= FILES_DISK_BYTES,
              f"phase 14 needs {FILES_DISK_BYTES / 1e9:.1f} GB of "
              f"temporary disk at {tmp}; {free / 1e9:.1f} GB free")
        prmtop = os.path.join(tmp, "config2.prmtop")
        t0 = time.perf_counter()
        write_prmtop(prmtop, u)
        print(f"files: PRMTOP of {u.atoms.n_atoms} atoms written with "
              f"io/prmtop.write_prmtop in {time.perf_counter() - t0:.2f} "
              f"s, {os.path.getsize(prmtop)} bytes")
        for label, ext, open_universe in (
                ("(a) Universe(top, trr)", "trr",
                 lambda p: Universe(top, p)),
                ("(b) Universe(prmtop, nc)", "nc",
                 lambda p: Universe(prmtop, p))):
            path = os.path.join(tmp, f"config2.{ext}")
            wall_w = write_pieces(path, u, n_frames, bs)
            print(f"files {label}: {n_frames} frames x {u.atoms.n_atoms} "
                  f"atoms written with TrajectoryWriter in {bs}-frame "
                  f"pieces: {wall_w:.2f} s, {os.path.getsize(path)} bytes")
            n, _ = file_rmsf_leg(card, label,
                                 lambda: open_universe(path), idx,
                                 rmsf_e2e)
            launches += n
            for leftover in os.listdir(tmp):
                if leftover.startswith(f"config2.{ext}"):
                    os.remove(os.path.join(tmp, leftover))
        vacf_file_legs(card, uw, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"files phase: {time.perf_counter() - t_phase:.1f} s, fused "
          f"launches {launches} on {card}")
    return launches


# ---------------------------------------------------------------- phase 9

def mesh_run(u, devices, **kw):
    """One fused int16 AlignedRMSF on a MeshExecutor over ``devices``
    (B = 512 a shard), with the kernel's count set to 0 just before and
    read just after → (analysis, wall s, launches)."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor

    u.trajectory.__dict__.pop("_quant_max_hints", None)
    mesh = MeshExecutor(batch_size=E2E_BATCH, devices=devices,
                        transfer_dtype="int16")
    torch.cuda.synchronize()
    fp.planar_sums.launches = 0
    t0 = time.perf_counter()
    r = AlignedRMSF(u, select="heavy", engine="fused").run(backend=mesh,
                                                           **kw)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, fp.planar_sums.launches, mesh


def per_device(mesh, launches):
    """The launches of a run by device: each shard launches the same
    number of times (once a global batch and pass), on its device."""
    devs = [str(d) for d in mesh.devices]
    each = launches // len(devs)
    return {d: each * devs.count(d) for d in dict.fromkeys(devs)}


def mesh_leg(card, u, rmsf_single):
    """Leg (a): phase 4's main path on a MeshExecutor over every visible
    card and over two shards of card 0 → (launches, the 2-shard RMSF,
    its moment partials)."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import pad_selection

    n_frames, bs = E2E_FRAMES, E2E_BATCH
    idx = u.select_atoms("heavy").indices
    n_cards = torch.cuda.device_count()
    total = 0
    for devices, tol, label in (
            (None, 1e-5, f"every visible card ({n_cards})"),
            (["cuda:0"] * 2, 5e-4, "two shards of cuda:0")):
        r, wall, launches, mesh = mesh_run(u, devices)
        n_dev = len(mesh.devices)
        n_batches = -(-n_frames // (bs * n_dev))
        check(launches == 2 * n_batches * n_dev,
              f"mesh over {label}: {launches} kernel launches, expected "
              f"{2 * n_batches * n_dev} (2 passes x {n_batches} global "
              f"batches x {n_dev} shards)")
        rmsf = r.results.rmsf
        err = np.abs(rmsf - rmsf_single).max()
        print(f"mesh {label}: AlignedRMSF(engine='fused') int16 B={bs} a "
              f"shard: wall {wall:.3f} s, {n_frames / wall:.1f} frames/s "
              f"(both passes), fused launches {launches}, by device "
              f"{per_device(mesh, launches)}; vs TorchExecutor max "
              f"|d rmsf| = {err:.3g} "
              f"(limit {tol:g}) on {card}")
        check(err <= tol, f"mesh over {label} vs TorchExecutor {err:.3g}")
        total += launches
        if devices is not None:
            rmsf2, moments2 = rmsf, r._last_total
    # the serial float64 oracle on the coordinates the int16 wire
    # delivers (the first 32 frames, staged as the run stages them)
    n32 = 32
    sel_p = pad_selection(idx)[0]
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    q, _, inv = u.trajectory.stage_block(0, n32, sel_p, "int16")
    u_wire = heavy_universe(q[:, :len(idx)].astype(np.float32)
                            * np.float32(inv))
    oracle = AlignedRMSF(u_wire, select="heavy").run(backend="serial")
    r32, _, launches, _ = mesh_run(u, ["cuda:0"] * 2, stop=n32)
    total += launches
    err = np.abs(r32.results.rmsf - oracle.results.rmsf).max()
    print(f"mesh two shards, {n32} frames, vs the serial f64 oracle on the "
          f"int16 wire coordinates: max |d rmsf| = {err:.3g} (limit 1e-3)")
    check(err <= 1e-3, f"mesh vs serial oracle on the wire {err:.3g}")
    return total, rmsf2, moments2


def rank_child(rank, port, frames_path, out_path):
    """One rank of leg (b): join a 2-rank gloo group, run the fused int16
    AlignedRMSF over the heavy-atom frames on a MeshExecutor over cuda:0
    (this rank stages its half of every 1,024-frame global batch), save
    the merged RMSF and print its wall and kernel launches."""
    import torch
    import torch.distributed as dist

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
    from mdanalysis_mpi_tpu_torch.parallel.distributed import (initialize,
                                                               world)
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor

    initialize(f"127.0.0.1:{port}", 2, rank, device="cuda",
               backend="gloo", timeout_s=RANK_TIMEOUT_S)
    check(world() == (rank, 2), f"rank {rank}: world {world()}")
    u = heavy_universe(np.load(frames_path))
    mesh = MeshExecutor(batch_size=E2E_BATCH, devices=["cuda:0"],
                        transfer_dtype="int16")
    torch.cuda.synchronize()
    fp.planar_sums.launches = 0
    t0 = time.perf_counter()
    r = AlignedRMSF(u, select="heavy", engine="fused").run(backend=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    np.save(out_path, r.results.rmsf)
    print(json.dumps({"rank": rank, "wall": wall,
                      "launches": fp.planar_sums.launches,
                      "backend": str(dist.get_backend())}))
    dist.destroy_process_group()


def two_rank_leg(card, heavy, rmsf_mesh, tmp):
    """Leg (b): two processes over torch.distributed (gloo: NCCL refuses
    two ranks on one GPU) on the one card, merged by all_reduce →
    launches of both ranks."""
    from mdanalysis_mpi_tpu_torch.testing import handoff_port

    frames_path = os.path.join(tmp, "heavy.npy")
    np.save(frames_path, heavy)
    holder, port = handoff_port()
    holder.close()
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank",
         str(rank), str(port), frames_path,
         os.path.join(tmp, f"rank{rank}.npy")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise SmokeFailure(f"two-rank leg: a rank ran over "
                           f"{RANK_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"two-rank leg: rank {rank} exited {p.returncode}:\n"
              f"{out[-3000:]}")
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    launches = sum(r["launches"] for r in reports)
    rmsfs = [np.load(os.path.join(tmp, f"rank{rank}.npy"))
             for rank in range(2)]
    check(np.array_equal(rmsfs[0], rmsfs[1]),
          "two-rank leg: the ranks hold different merged RMSF")
    n_batches = -(-heavy.shape[0] // (2 * E2E_BATCH))
    check(all(r["launches"] == 2 * n_batches for r in reports),
          f"two-rank leg: launches per rank {[r['launches'] for r in reports]}"
          f", expected {2 * n_batches} each")
    err = np.abs(rmsfs[0] - rmsf_mesh).max()
    print(f"two ranks on one card ({reports[0]['backend']}, "
          f"all_reduce of the moments): run walls "
          + " / ".join(f"{r['wall']:.3f}" for r in reports)
          + f" s ({heavy.shape[0] / max(r['wall'] for r in reports):.1f} "
          f"frames/s), {wall:.1f} s with process start, fused launches "
          + " + ".join(str(r["launches"]) for r in reports)
          + f"; vs the mesh leg max |d rmsf| = {err:.3g} (limit 1e-3) "
          f"on {card}")
    check(err <= 1e-3, f"two-rank leg vs mesh leg {err:.3g}")
    return launches


def nccl_leg(total):
    """One NCCL all_reduce at world size 1 (the moment merge with the
    process group), so the NCCL path is built and run on the card."""
    import torch
    import torch.distributed as dist

    from mdanalysis_mpi_tpu_torch.ops.moments import psum_moments
    from mdanalysis_mpi_tpu_torch.parallel.distributed import Collectives
    from mdanalysis_mpi_tpu_torch.testing import handoff_port

    holder, port = handoff_port()
    holder.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        comm = Collectives()
        got = psum_moments([total], comm)
        want = psum_moments([total])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"nccl all_reduce at world size 1: backend {comm.backend}, "
              f"moments on {got[1].device}, equal to the merge without "
              f"the group: {same}")
        check(comm.backend == "nccl" and got[1].is_cuda and same,
              "nccl all_reduce of the moments failed")
    finally:
        dist.destroy_process_group()


def ring_leg(card):
    """Leg (c): InterRDF(engine='ring') over two shards of cuda:0 against
    engine='xla' on the card."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor

    u, ow = make_water(RING_WATERS, RING_BOX, RING_FRAMES)
    out = {}
    for engine, backend in (
            ("ring", dict(backend=MeshExecutor(
                batch_size=RING_FRAMES, devices=["cuda:0"] * 2))),
            ("xla", dict(backend="torch", device="cuda",
                         batch_size=RING_FRAMES))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = InterRDF(ow, ow, engine=engine).run(**backend)
        count, rdf = r.results.count, r.results.rdf
        out[engine] = (count, rdf, time.perf_counter() - t0)
    (rc, rr, wr), (xc, xr, wx) = out["ring"], out["xla"]
    err = max(float(np.max(np.abs(rc - xc) / np.maximum(np.abs(xc), 1e-30))),
              float(np.max(np.abs(rr - xr) / np.maximum(np.abs(xr), 1e-30))))
    pairs = RING_FRAMES * len(ow) * (len(ow) - 1)
    print(f"ring RDF {len(ow)} waters x {RING_FRAMES} frames over two "
          f"shards of cuda:0: wall {wr:.3f} s ({RING_FRAMES / wr:.1f} "
          f"frames/s, {pairs / wr:.3g} pairs/s); engine='xla' {wx:.3f} s; "
          f"largest relative difference of counts and g(r) {err:.3g} "
          f"(limit 1e-5) on {card}")
    check(np.allclose(rc, xc, rtol=1e-5, atol=0)
          and np.allclose(rr, xr, rtol=1e-5, atol=0),
          f"ring vs xla RDF differ by {err:.3g}")


def stream_leg(card, heavy, tmp):
    """Leg (d): run_streaming of the fused int16 AlignedRMSF on a follow
    store fed by a LiveIngest thread → launches."""
    import threading

    import torch

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.io.store import LiveIngest, StoreReader
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    frames = heavy[:STREAM_FRAMES]
    top = heavy_universe(frames[:1]).topology
    store = os.path.join(tmp, "live.store")
    live = LiveIngest(out=store, n_atoms=frames.shape[1],
                      chunk_frames=STREAM_CHUNK)
    errors = []
    t_ingest = {}

    def writer():
        try:
            t0 = time.perf_counter()
            for lo in range(0, len(frames), STREAM_CHUNK):
                for f in frames[lo:lo + STREAM_CHUNK]:
                    live.append(f)
            live.seal()
            t_ingest["s"] = time.perf_counter() - t0
        except Exception as exc:          # surfaced after the join
            errors.append(exc)

    run_kw = dict(backend="torch", device="cuda", batch_size=STREAM_CHUNK,
                  transfer_dtype="int16")
    thread = threading.Thread(target=writer)
    torch.cuda.synchronize()
    fp.planar_sums.launches = 0
    t0 = time.perf_counter()
    thread.start()
    try:
        r = AlignedRMSF(Universe(top, StoreReader(store, follow=True)),
                        select="heavy", engine="fused").run_streaming(
            window=STREAM_CHUNK, poll_interval_s=0.01,
            stall_timeout_s=120.0, **run_kw)
    finally:
        thread.join(timeout=120)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fp.planar_sums.launches
    check(not thread.is_alive() and not errors,
          f"stream leg: the writer failed: {errors}")
    seq = [s["frames"] for s in r.results.stream_snapshots]
    check(seq == sorted(set(seq)) and seq[-1] == len(frames),
          f"stream leg: snapshots not monotone to {len(frames)}: {seq}")
    closed = AlignedRMSF(Universe(top, StoreReader(store)), select="heavy",
                         engine="fused").run(**run_kw)
    err = np.abs(r.results.rmsf - closed.results.rmsf).max()
    print(f"stream AlignedRMSF(engine='fused') int16 from a follow store "
          f"({frames.shape[1]} atoms, {len(frames)} frames in "
          f"{STREAM_CHUNK}-frame chunks, ingest {t_ingest['s']:.3f} s): "
          f"wall {wall:.3f} s ({len(frames) / wall:.1f} frames/s of feed), "
          f"snapshots at {seq}, fused launches {launches}; final vs the "
          f"closed-file run max |d rmsf| = {err:.3g} (limit 1e-5) on {card}")
    check(err <= 1e-5, f"stream final vs closed-file run {err:.3g}")
    return launches


def phase_multi(card, u, rmsf_single):
    """Phase 9: the mesh executor on the card, two ranks on the one card,
    the ring RDF and streaming → the fused kernel's launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    launches, rmsf_mesh, moments = mesh_leg(card, u, rmsf_single)
    idx = u.select_atoms("heavy").indices
    heavy = np.ascontiguousarray(
        u.trajectory.read_block(0, E2E_FRAMES, sel=idx)[0])
    tmp = tempfile.mkdtemp(prefix="mdtpu_multi_")
    try:
        launches += two_rank_leg(card, heavy, rmsf_mesh, tmp)
        nccl_leg(moments)
        ring_leg(card)
        launches += stream_leg(card, heavy, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, time.perf_counter() - t_phase


# ---------------------------------------------------------------- phase 10

def graph_counts():
    """This process's captured-graph counts (``utils/compile_cache``)."""
    from mdanalysis_mpi_tpu_torch.utils import compile_cache

    c = compile_cache.counters()
    return {k: c[k] for k in ("graph_misses", "graph_hits", "replays",
                              "build_misses")}


def count_delta(before, after):
    return {k: after[k] - before[k] for k in before}


def kernel_counts():
    """The two kernels' launch counts: (fused, pair histogram)."""
    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    return fp.planar_sums.launches, fd.pair_histogram.launches


def counted(fn, tally):
    """``fn()`` with the two kernels' launches during it added to
    ``tally`` ([fused, pair histogram]) → its result.  ``fn`` must not
    reset the counts (``fused_passes`` does; add its own count)."""
    f0, p0 = kernel_counts()
    out = fn()
    f1, p1 = kernel_counts()
    tally[0] += f1 - f0
    tally[1] += p1 - p0
    return out


SCAN_LEGS = ("first", "repeat 1", "repeat 2", "repeat 3")


def scan_legs(card, u, run, label, n_launch, tally,
              get=lambda r: r.results["rmsf"]):
    """``run(scan_k, cache)`` with ``scan_k=1`` then ``'auto'``, each a
    first run and three repeats over one cache (a group runs eagerly at
    its first hit, is captured at its second and replayed from then
    on) → (the 'auto' cache, its last run).  Every run's result
    (``get``, a tensor on the card) must equal the first ``scan_k=1``
    run's (``torch.equal``) and launch the kernels ``n_launch`` times;
    adds the launches to ``tally`` and prints each run's wall, pass
    split and graph counts."""
    import torch

    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache

    ref, out = None, None
    for scan_k in (1, "auto"):
        cache = DeviceBlockCache()
        for leg in SCAN_LEGS:
            g0 = graph_counts()
            _, p0 = kernel_counts()
            r, wall, t1, l1, fused = fused_passes(
                lambda: run(scan_k, cache))
            ph = kernel_counts()[1] - p0
            tally[0] += fused
            tally[1] += ph
            g = count_delta(g0, graph_counts())
            got = get(r)
            ref = got if ref is None else ref
            check(torch.equal(got, ref),
                  f"{label}: scan_k={scan_k} {leg} not equal to scan_k=1")
            check(n_launch is None or fused + ph == n_launch,
                  f"{label}: scan_k={scan_k} {leg} launched {fused + ph} "
                  f"times, expected {n_launch}")
            split = (f"pass 1 {t1:.3f} s, pass 2 {wall - t1:.3f} s, "
                     if l1 or t1 else "")
            print(f"scan {label} scan_k={scan_k} {leg}: wall {wall:.3f} s "
                  f"({split}launches {fused + ph}), graphs captured "
                  f"{g['graph_misses']}, replayed {g['replays']}, equal "
                  f"to scan_k=1 on {card}")
            out = (cache, r)
    return out


def own_waits(waits, base):
    """Host waits of a profiled call beyond those of profiling nothing
    (``base``: the profile's own and its closing synchronize)."""
    return sum(waits.values()) - sum(base.values())


def replay_waits(cache, label, base, tally):
    """One replay of each graph in ``cache`` under ``host_syncs``: none
    may wait on the card beyond ``base`` (the waits of profiling an
    empty call).  The replays' launches are added to ``tally``."""
    import torch

    dev = torch.device("cuda")
    for prog in cache.graphs():
        _, waits, dtoh = counted(lambda: host_syncs(
            lambda: prog.replay(prog.params, prog.total, dev)), tally)
        own = own_waits(waits, base)
        print(f"scan {label}: one replay of a {len(prog.launches)}-"
              f"kernel-launch graph: waits {waits} ({own} of its own "
              f"beyond an empty profile's {base}), {dtoh} "
              f"device-to-host copies")
        check(own == 0 and dtoh == 0,
              f"{label}: a replayed group waited on the card {own} "
              f"time(s) of its own, {dtoh} copies to the host")


WARMUP_FRAMES = 1024


def warmup_child(mode, frames_path, out_path):
    """One fresh process of phase 10 (f): phase 4's heavy atoms over
    their first ``WARMUP_FRAMES`` frames (``frames_path``),
    ``warmup_analysis`` first when ``mode`` is ``'warm'``, then one
    fused int16 AlignedRMSF run; prints the build misses of each step,
    the walls and launches, and saves the RMSF to ``out_path``."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, TorchExecutor, warmup_analysis)

    u = heavy_universe(np.load(frames_path))
    exe = TorchExecutor(batch_size=E2E_BATCH, device="cuda",
                        transfer_dtype="int16",
                        block_cache=DeviceBlockCache())
    g0 = graph_counts()
    t0 = time.perf_counter()
    n = (warmup_analysis(AlignedRMSF(u, select="heavy", engine="fused"),
                         exe) if mode == "warm" else 0)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    g1 = graph_counts()
    r, wall, _, _, launches = fused_passes(
        lambda: AlignedRMSF(u, select="heavy", engine="fused").run(
            backend=exe))
    g2 = graph_counts()
    np.save(out_path, r.results["rmsf"].cpu().numpy())
    print(json.dumps({
        "programs": n, "warmup_s": t_warm, "run_s": wall,
        "launches": launches,
        "warmup_builds": g1["build_misses"] - g0["build_misses"],
        "run_builds": g2["build_misses"] - g1["build_misses"]}))


def warmup_leg(card, u, tmp):
    """Phase 10 (f): the same first run in two fresh processes, one
    without and one after ``warmup_analysis``.  The cold run must build
    (load) the kernel library once, the warm process's warmup must do
    it and its run must build nothing; both RMSF equal."""
    frames_path = os.path.join(tmp, "warmup_frames.npy")
    np.save(frames_path, u.trajectory.read_block(
        0, WARMUP_FRAMES, sel=u.select_atoms("heavy").indices)[0])
    env = dict(os.environ, PYTHONPATH=HERE)
    reports, rmsfs = {}, {}
    for mode in ("cold", "warm"):
        out_path = os.path.join(tmp, f"warmup_{mode}.npy")
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--warmup-probe", mode, frames_path, out_path],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"warmup leg: the {mode} process ran over "
                               f"{RANK_TIMEOUT_S} s")
        check(proc.returncode == 0,
              f"warmup leg: the {mode} process exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}")
        reports[mode] = json.loads([
            line for line in proc.stdout.splitlines()
            if line.startswith("{")][-1])
        rmsfs[mode] = np.load(out_path)
    cold, warm = reports["cold"], reports["warm"]
    n_launch = 2 * (-(-WARMUP_FRAMES // E2E_BATCH))
    check(cold["run_builds"] == 1 and warm["warmup_builds"] == 1
          and warm["run_builds"] == 0,
          f"warmup leg: build misses cold run {cold['run_builds']}, "
          f"warmup {warm['warmup_builds']}, warm run {warm['run_builds']}")
    check(warm["programs"] >= 4, f"warmup leg: {warm['programs']} programs")
    check(cold["launches"] == warm["launches"] == n_launch,
          f"warmup leg: launches {cold['launches']} / {warm['launches']}, "
          f"expected {n_launch}")
    check(np.array_equal(rmsfs["cold"], rmsfs["warm"]),
          "warmup leg: the warmed run's RMSF differs from the cold run's")
    print(f"scan warmup: fresh processes, {WARMUP_FRAMES} frames: a cold "
          f"first run {cold['run_s']:.3f} s (build misses "
          f"{cold['run_builds']}); warmup_analysis {warm['warmup_s']:.3f} s "
          f"({warm['programs']} programs, build misses "
          f"{warm['warmup_builds']}), then the first run "
          f"{warm['run_s']:.3f} s (build misses {warm['run_builds']}); "
          f"launches {cold['launches']} each, RMSF equal, on {card}")


def phase_scan(card, u, uw, ow):
    """Phase 10: dispatch folding, checkpointing and resilient runs on
    phase 4's system → (fused launches, pair-histogram launches), each
    the sum of the counts measured around every call of the phase that
    launches a kernel (profiled replays included)."""
    import tempfile

    import torch

    from mdanalysis_mpi_tpu_torch import _build
    from mdanalysis_mpi_tpu_torch.analysis import (RMSD, AlignedRMSF,
                                                   InterRDF)
    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, TorchExecutor)
    from mdanalysis_mpi_tpu_torch.reliability import faults
    from mdanalysis_mpi_tpu_torch.reliability.policy import (
        ReliabilityPolicy)
    from mdanalysis_mpi_tpu_torch.utils.checkpoint import run_checkpointed

    t_phase = time.perf_counter()
    bs, sel = E2E_BATCH, "heavy"
    run_kw = dict(backend="torch", device="cuda", batch_size=bs)
    n_blocks = -(-E2E_FRAMES // bs)
    hints = u.trajectory.__dict__
    _, base, _ = host_syncs(lambda: None)
    tally = [0, 0]

    # (a) the main path: fused int16, per-block against folded
    def fused(scan_k, cache, **kw):
        hints.pop("_quant_max_hints", None)
        return AlignedRMSF(u, select=sel, engine="fused").run(
            transfer_dtype="int16", block_cache=cache, scan_k=scan_k,
            **run_kw, **kw)

    cache_a, r_a = scan_legs(card, u, fused, "int16 fused", 2 * n_blocks,
                             tally)
    rmsf_a = r_a.results["rmsf"]
    progs = cache_a.graphs()
    check(len(progs) == 2 and all(
        len(p.launches) == n_blocks
        and all(w is fp.planar_sums for w in p.launches) for p in progs),
          f"int16 fused: not two graphs of {n_blocks} fused launches")
    replay_waits(cache_a, "int16 fused", base, tally)
    _, run_waits, _ = counted(lambda: host_syncs(
        lambda: fused("auto", cache_a)), tally)
    print(f"scan int16 fused: a whole replayed run (both passes cached): "
          f"waits {run_waits}, {own_waits(run_waits, base)} of its own")

    # (b) float32: the generic form (QCP on the device), then RMSD
    def generic(scan_k, cache):
        return AlignedRMSF(u, select=sel).run(
            transfer_dtype="float32", block_cache=cache, scan_k=scan_k,
            **run_kw)

    cache_b, _ = scan_legs(card, u, generic, "float32 generic", 0, tally)
    replay_waits(cache_b, "float32 generic", base, tally)
    del cache_b

    def rmsd(scan_k, cache):
        return RMSD(u, select=sel).run(transfer_dtype="float32",
                                       block_cache=cache, scan_k=scan_k,
                                       **run_kw)

    cache_r, _ = scan_legs(card, u, rmsd, "rmsd float32", 0, tally,
                           get=lambda r: r.results["rmsd"])
    replay_waits(cache_r, "rmsd float32", base, tally)
    _, w_plain, _ = host_syncs(lambda: RMSD(u, select=sel).run(
        transfer_dtype="float32", **run_kw))
    _, w_scan, _ = host_syncs(lambda: rmsd("auto", cache_r))
    print(f"scan rmsd: host waits of a whole float32 RMSD run of "
          f"{n_blocks} blocks (a batched SVD's: 11 with the closing "
          f"synchronize): without a cache {w_plain} "
          f"({own_waits(w_plain, base)} of its own); replayed from the "
          f"cache {w_scan} ({own_waits(w_scan, base)} of its own)")
    del cache_r

    # (c) a cached InterRDF repeat at phase 5's shape
    def rdf(scan_k, cache):
        return InterRDF(ow, ow).run(backend="torch", device="cuda",
                                    batch_size=RDF_BATCH, block_cache=cache,
                                    scan_k=scan_k)

    n_rdf = -(-RDF_FRAMES // RDF_BATCH)
    cache_c, _ = scan_legs(card, uw, rdf, "rdf", n_rdf, tally,
                           get=lambda r: r._last_total[0])
    replay_waits(cache_c, "rdf", base, tally)
    progs = cache_c.graphs()
    check(len(progs) == 1 and all(
        len(p.launches) == n_rdf
        and all(w is fd.pair_histogram for w in p.launches) for p in progs),
          f"rdf: not one graph of {n_rdf} pair-histogram launches")
    del cache_c

    # (d) two-pass checkpointing: a crash in pass 2, then a resume
    tmp = tempfile.mkdtemp(prefix="mdtpu_ckpt_")
    try:
        ck_kw = dict(chunk_frames=E2E_FRAMES // 2, checkpoint_dir=tmp)

        def exe(cache):
            return TorchExecutor(batch_size=bs, device="cuda",
                                 transfer_dtype="int16", block_cache=cache)

        hints.pop("_quant_max_hints", None)
        whole = AlignedRMSF(u, select=sel, engine="fused")
        t0 = time.perf_counter()
        counted(lambda: run_checkpointed(
            whole, backend=exe(DeviceBlockCache()), **ck_kw), tally)
        t_whole = time.perf_counter() - t0
        hints.pop("_quant_max_hints", None)
        cache_d = DeviceBlockCache()
        # visits: pass 1 stages 2 blocks a chunk (4), pass 2 one group a
        # chunk: the 6th visit is pass 2's second chunk
        crash = faults.FaultSpec("kernel", "raise", after=5, times=1,
                                 exc=faults.InjectedCrash)
        with faults.inject(crash):
            try:
                counted(lambda: run_checkpointed(
                    AlignedRMSF(u, select=sel, engine="fused"),
                    backend=exe(cache_d), **ck_kw), tally)
            except faults.InjectedCrash:
                pass
            else:
                check(False, "checkpoint: the injected crash did not fire")
        files = sorted(os.listdir(tmp))
        check(len(files) == 2, f"checkpoint: {files} after the crash")
        resumed = AlignedRMSF(u, select=sel, engine="fused")
        t0 = time.perf_counter()
        counted(lambda: run_checkpointed(resumed, backend=exe(cache_d),
                                         **ck_kw), tally)
        t_resume = time.perf_counter() - t0
        check(not os.listdir(tmp), "checkpoint files left after success")
        check(torch.equal(resumed.results["rmsf"], whole.results["rmsf"]),
              "checkpoint: the resumed run is not equal to the whole run")
        print(f"scan checkpoint: two passes in {E2E_FRAMES // 2}-frame "
              f"chunks, a crash at pass 2's second chunk, then a resume "
              f"(pass 1 loaded, pass 2 from its saved first chunk): equal "
              f"to the uninterrupted run; uninterrupted {t_whole:.3f} s, "
              f"resume {t_resume:.3f} s; files {files}; on {card}")

        # (e) resilient: no fault stays fused; transient kernel faults
        # retry on the same rung; a refused launch and an exhausted
        # chain raise (on the card nothing finishes without the kernel)
        pol = ReliabilityPolicy(backoff_s=0.001, checkpoint_dir=tmp)
        r_e, wall_e, _, _, l_e = fused_passes(
            lambda: fused("auto", None, resilient=pol))
        tally[0] += l_e
        rel = r_e.results.reliability
        d_e = float((r_e.results["rmsf"] - rmsf_a).abs().max())
        check(l_e == 2 * n_blocks and list(rel["fallbacks"]) == [],
              f"resilient: launches {l_e}, fallbacks {rel['fallbacks']}")
        check(d_e == 0.0, f"resilient: {d_e:.3g} from (a)")
        with faults.inject(faults.FaultSpec("kernel", "raise", times=2)):
            r_f, wall_f, _, _, l_f = fused_passes(
                lambda: fused("auto", None, resilient=pol))
        tally[0] += l_f
        rel_f = r_f.results.reliability
        d_f = float((r_f.results["rmsf"] - rmsf_a).abs().max())
        check(l_f == 2 * n_blocks and list(rel_f["fallbacks"]) == []
              and rel_f["retries"].get("kernel") == 2,
              f"resilient retry: launches {l_f}, retries "
              f"{rel_f['retries']}, fallbacks {rel_f['fallbacks']}")
        check(d_f == 0.0, f"resilient retry: {d_f:.3g} from (a)")
        raised = {}
        for name, spec in (
                ("refused launch", faults.FaultSpec(
                    "kernel", "raise", times=1,
                    exc=_build.KernelLaunchError)),
                ("exhausted retries", faults.FaultSpec(
                    "kernel", "raise", times=None))):
            with faults.inject(spec):
                try:
                    counted(lambda: fused("auto", None, resilient=pol),
                            tally)
                except (_build.KernelLaunchError,
                        faults.DeviceLossError) as exc:
                    raised[name] = type(exc).__name__
                else:
                    check(False, f"resilient: a {name} on the card did "
                          f"not raise")
        print(f"scan resilient: no fault: wall {wall_e:.3f} s, launches "
              f"{l_e} (as the plain run), no demotion, RMSF equal to "
              f"(a)'s; 2 injected transient kernel faults: wall "
              f"{wall_f:.3f} s, retried on the fused rung "
              f"({rel_f['retries']}), launches {l_f}, RMSF equal to "
              f"(a)'s; raised on the card: {raised}; on {card}")
        warmup_leg(card, u, tmp)
    finally:
        faults.clear()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(f"scan phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    return tally[0], tally[1]


# ---------------------------------------------------------------- phase 11

def pair_keys(pairs, m):
    return pairs[:, 0] * m + pairs[:, 1]


def compare_pairs(label, got, want, a, b, dims, cutoffs):
    """Hold the torch engine's ``(pairs, distances)`` to a host
    engine's: the same pairs in the same (i, j) order, but for pairs
    whose float64 distance lies within ``NS_EDGE`` of a cutoff (the
    float32 class of the torch engine), and the common pairs' distances
    within ``NS_DIST_TOL`` → the number of such edge pairs."""
    from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

    (pt, dt), (pg, dg) = got, want
    m = len(b)
    kt, kg = pair_keys(pt, m), pair_keys(pg, m)
    check(bool((np.diff(kt) > 0).all()),
          f"{label}: torch pairs not in (i, j) order")
    _, it, ig = np.intersect1d(kt, kg, assume_unique=True,
                               return_indices=True)
    only = np.setxor1d(kt, kg, assume_unique=True)
    i, j = only // m, only % m
    d = np.sqrt((minimum_image(b[j] - a[i], dims) ** 2).sum(-1))
    edge = np.min([np.abs(d - c) for c in cutoffs], axis=0) if len(
        only) else np.empty(0)
    far = edge[edge > NS_EDGE]
    check(len(far) == 0,
          f"{label}: {len(far)} pairs differ away from the cutoff (largest "
          f"distance from it {far.max() if len(far) else 0:.3g} Å)")
    err = float(np.abs(dt[it] - dg[ig]).max()) if len(it) else 0.0
    check(err <= NS_DIST_TOL,
          f"{label}: common distances differ by {err:.3g} Å")
    return len(only), err


def cell_list_leg(card, label, a, b, dims, cutoff, min_cutoff=None,
                  self_query=False):
    """One capped query by ``engine='torch'`` (twice: a first call and a
    repeat) and by ``engine='nsgrid'`` on the host, compared."""
    import torch

    from mdanalysis_mpi_tpu_torch.lib.distances import (capped_distance,
                                                        self_capped_distance)
    from mdanalysis_mpi_tpu_torch.ops import neighbors

    def query(engine, **kw):
        if self_query:
            return self_capped_distance(a, cutoff, min_cutoff=min_cutoff,
                                        box=dims, engine=engine, **kw)
        return capped_distance(a, b, cutoff, min_cutoff=min_cutoff,
                               box=dims, engine=engine, **kw)

    _, n_cells, cap = neighbors.plan_query(a, b, cutoff, dims)
    torch.cuda.reset_peak_memory_stats()
    got, t_first = timed(lambda: query("torch", device=NS_DEVICE))
    peak = torch.cuda.max_memory_allocated()
    again, t_repeat = timed(lambda: query("torch", device=NS_DEVICE))
    check(np.array_equal(got[0], again[0])
          and np.array_equal(got[1], again[1]),
          f"{label}: the repeat differs from the first call")
    t0 = time.perf_counter()
    want = query("nsgrid")
    t_host = time.perf_counter() - t0
    n_edge, err = compare_pairs(
        label, got, want, a, b, dims,
        [cutoff] if min_cutoff is None else [cutoff, min_cutoff])
    cand = len(a) * 27 * cap
    print(f"neighbours {label}: {len(a)} x {len(b)} atoms, cutoff {cutoff}"
          f"{'' if min_cutoff is None else f' min_cutoff {min_cutoff}'} Å: "
          f"K {len(got[0])} pairs (nsgrid {len(want[0])}), {n_edge} differ "
          f"within {NS_EDGE} Å of a cutoff, common distances within "
          f"{err:.3g} Å (limit {NS_DIST_TOL}); grid {tuple(n_cells)}, "
          f"capacity {cap}, {cand} candidates ({cand * 8} bytes of int64 "
          f"indices), peak {peak} bytes allocated; engine='torch' first "
          f"{t_first:.3f} s, repeat {t_repeat:.3f} s; engine='nsgrid' "
          f"{t_host:.3f} s on {card}")
    return got


def guess_bonds_leg(card, u):
    """(b): guess_bonds by the torch cell list and by 'auto' → the
    bonds; the bond lengths and the guessed angles against the plain
    formula on the host."""
    from mdanalysis_mpi_tpu_torch.core.topologyobjects import guess_angles

    top = u.topology
    got, t_torch = timed(lambda: u.atoms.guess_bonds(engine="torch",
                                                     device=NS_DEVICE))
    torch_bonds = top.bonds.copy()
    top.bonds = None
    t0 = time.perf_counter()
    want = u.atoms.guess_bonds(engine="auto")
    t_auto = time.perf_counter() - t0
    check(np.array_equal(got, want) and np.array_equal(torch_bonds,
                                                       top.bonds),
          f"guess_bonds: torch {len(got)} bonds, auto {len(want)}")
    same_res = top.resindices[want[:, 0]] == top.resindices[want[:, 1]]
    is_o = top.names == "OW"
    n_oh = int((same_res & (is_o[want[:, 0]] ^ is_o[want[:, 1]])).sum())
    n_waters = top.n_residues
    check(n_oh == 2 * n_waters,
          f"guess_bonds: {n_oh} O-H bonds inside waters for {n_waters} "
          "waters")
    pos = u.trajectory.ts.positions.astype(np.float64)
    box = np.asarray(u.trajectory.ts.dimensions[:3], np.float64)

    def mi(d):
        return d - box * np.round(d / box)

    t0 = time.perf_counter()
    lengths = u.bonds.values()
    b = top.bonds
    plain = np.sqrt((mi(pos[b[:, 1]] - pos[b[:, 0]]) ** 2).sum(-1))
    e_len = float(np.abs(lengths - plain).max())
    top.angles = guess_angles(b, top.n_atoms)
    angles = u.angles.values()
    t_values = time.perf_counter() - t0
    ang = top.angles
    v1 = mi(pos[ang[:, 0]] - pos[ang[:, 1]])
    v2 = mi(pos[ang[:, 2]] - pos[ang[:, 1]])
    cos = (v1 * v2).sum(-1) / np.sqrt((v1 ** 2).sum(-1) * (v2 ** 2).sum(-1))
    e_ang = float(np.abs(angles - np.degrees(np.arccos(np.clip(
        cos, -1, 1)))).max())
    check(e_len <= 1e-9 and e_ang <= 1e-6,
          f"bond values vs plain formula: lengths {e_len:.3g} Å, angles "
          f"{e_ang:.3g} deg")
    print(f"neighbours guess_bonds: {u.atoms.n_atoms} atoms, {len(got)} "
          f"bonds ({n_oh} O-H inside waters), equal from engine='torch' "
          f"({t_torch:.3f} s) and 'auto' ({t_auto:.3f} s); {len(ang)} "
          f"guessed angles; values() vs the plain formula: lengths "
          f"{e_len:.3g} Å, angles {e_ang:.3g} deg ({t_values:.3f} s) on "
          f"{card}")
    return len(got)


def hbond_leg(card):
    """(c): HydrogenBondAnalysis on its batch path on the card."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import HydrogenBondAnalysis
    from mdanalysis_mpi_tpu_torch.analysis.hbonds import _hbond_count_kernel
    from mdanalysis_mpi_tpu_torch.device import resolve_device
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, TorchExecutor)
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=HB_WATERS, box=HB_BOX,
                            n_frames=HB_FRAMES, seed=0)
    probe = HydrogenBondAnalysis(u)
    probe._frame_indices = [0]
    t0 = time.perf_counter()
    probe._prepare()
    t_prep = time.perf_counter() - t0
    n_pairs = len(probe._h_idx) * len(probe._a_idx)
    check(n_pairs <= HydrogenBondAnalysis.MAX_BATCH_PAIRS,
          f"hbonds: {n_pairs} pairs over the batch limit")

    # the batch function alone on one staged block, CUDA events
    dev = resolve_device(NS_DEVICE)
    params = tuple(p.to(dev) if isinstance(p, torch.Tensor) else p
                   for p in probe._batch_params())
    block = torch.as_tensor(u.trajectory.read_block(0, HB_BATCH)[0][
        :, probe._idx]).to(dev)
    boxes = torch.as_tensor(np.tile(u.trajectory.ts.dimensions,
                                    (HB_BATCH, 1))).to(dev)
    ones = torch.ones(HB_BATCH, device=dev)
    torch.cuda.reset_peak_memory_stats()
    fn_ms = sorted(event_ms(lambda: _hbond_count_kernel(
        params, block, boxes, ones))[1] for _ in range(3))[1]
    peak = torch.cuda.max_memory_allocated()
    del params, block, boxes, ones

    first, t_first = timed(lambda: torch.as_tensor(
        HydrogenBondAnalysis(u).run(batch_size=HB_BATCH, device=NS_DEVICE,
                                    scan_k=1).results.count))
    check(first.shape == (HB_FRAMES,), f"hbonds: count {first.shape}")
    # over one cache: a first run per block, a repeat eager at the
    # group's first hit, a repeat captured as a CUDA graph at its second
    # hit and replayed: all equal to the per-block run
    exe = TorchExecutor(device=NS_DEVICE, batch_size=HB_BATCH,
                        block_cache=DeviceBlockCache(), scan_k="auto")
    g0 = graph_counts()
    walls = []
    for _ in range(3):
        r, w = timed(lambda: HydrogenBondAnalysis(u).run(backend=exe))
        walls.append(w)
        check(torch.equal(torch.as_tensor(r.results.count), first),
              "hbonds: a run on the card differs from the per-block run")
    g = count_delta(g0, graph_counts())
    check(g["graph_misses"] >= 1 and g["replays"] >= 1,
          f"hbonds: no graph captured and replayed ({g})")
    t0 = time.perf_counter()
    serial = HydrogenBondAnalysis(u).run(
        backend="serial", stop=HB_SERIAL_FRAMES).results.count
    t_serial = time.perf_counter() - t0
    diff = np.abs(first.numpy()[:HB_SERIAL_FRAMES] - serial)
    check(bool((diff <= HB_REL_TOL * serial).all()),
          f"hbonds vs serial: largest difference {diff.max()} bonds")
    check(float(serial.sum()) > 0, "hbonds: the serial run found no bond")
    print(f"neighbours hbonds: {HB_WATERS} waters ({u.atoms.n_atoms} atoms) "
          f"x {HB_FRAMES} frames, {len(probe._h_idx)} H x "
          f"{len(probe._a_idx)} acceptors = {n_pairs} candidate pairs, "
          f"batch {HB_BATCH}: run {t_first:.3f} s ({HB_FRAMES / t_first:.1f}"
          f" frames/s; the host's donor guess alone {t_prep:.3f} s; the "
          f"batch function {fn_ms / HB_BATCH:.3f} ms a frame on one block, "
          f"peak {peak} bytes allocated); {int(first.sum())} bonds in all; "
          f"serial {HB_SERIAL_FRAMES} frames {t_serial:.3f} s "
          f"({HB_SERIAL_FRAMES / t_serial:.1f} frames/s), largest per-frame "
          f"difference {diff.max():g} bonds (limit {HB_REL_TOL:g} of the "
          f"frame's count); scan_k='auto' over one cache: first / eager "
          f"repeat / captured repeat {' / '.join(f'{w:.3f}' for w in walls)}"
          f" s, graphs captured {g['graph_misses']}, replayed "
          f"{g['replays']}, all equal on {card}")


def bilayer(side):
    """Two side x side sheets of headgroups, 8 Å apart in-plane and
    30 Å across, jittered from seed 11 (tests/test_nsgrid.py's
    TestConsumersRouted at scale)."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                             indexing="ij"), -1).reshape(-1, 2) * 8.0
    n = len(g)
    pos = np.zeros((2 * n, 3), np.float32)
    pos[:n, :2] = g
    pos[n:, :2] = g
    pos[n:, 2] = 30.0
    pos += rng.normal(scale=0.4, size=pos.shape).astype(np.float32)
    top = Topology(names=np.full(2 * n, "P"), resnames=np.full(2 * n, "POPC"),
                   resids=np.arange(1, 2 * n + 1))
    dims = np.array([side * 8.0, side * 8.0, side * 8.0, 90, 90, 90],
                    np.float32)
    return Universe(top, MemoryReader(pos[None], dimensions=dims)), n


def host_legs(card, u_bonded):
    """(d): LeafletFinder, the sparse contact matrix and make_whole."""
    from mdanalysis_mpi_tpu_torch.analysis import LeafletFinder
    from mdanalysis_mpi_tpu_torch.analysis.distances import contact_matrix
    from mdanalysis_mpi_tpu_torch.lib.mdamath import make_whole
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    ub, n = bilayer(LEAFLET_SIDE)
    t0 = time.perf_counter()
    lf = LeafletFinder(ub, "name P", cutoff=12.0, pbc=True)
    t_lf = time.perf_counter() - t0
    check(lf.sizes() == [n, n], f"LeafletFinder sizes {lf.sizes()[:4]}")
    lft, t_lft = timed(lambda: LeafletFinder(
        ub, "name P", cutoff=12.0, pbc=True, engine="torch",
        device=NS_DEVICE))
    check([g.indices.tolist() for g in lft.groups()]
          == [g.indices.tolist() for g in lf.groups()],
          "LeafletFinder: engine='torch' groups differ from 'auto'")
    uw = make_water_universe(n_waters=HB_WATERS, box=HB_BOX, n_frames=1,
                             seed=0)
    x = uw.select_atoms("name OW").positions
    box = uw.trajectory.ts.dimensions
    t0 = time.perf_counter()
    sp = contact_matrix(x, 6.0, returntype="sparse", box=box)
    t_sp = time.perf_counter() - t0
    check(np.array_equal(sp.toarray(), contact_matrix(x, 6.0, box=box)),
          "contact_matrix: sparse differs from dense")
    ts = u_bonded.trajectory.ts
    lx = float(ts.dimensions[0])
    ts.positions = ts.positions % lx
    b = u_bonded.topology.bonds
    broken = int((np.linalg.norm(ts.positions[b[:, 1]]
                                 - ts.positions[b[:, 0]], axis=1) > 2.0).sum())
    t0 = time.perf_counter()
    whole = make_whole(u_bonded.atoms, inplace=False)
    t_mw = time.perf_counter() - t0
    longest = float(np.linalg.norm(whole[b[:, 1]] - whole[b[:, 0]],
                                   axis=1).max())
    check(broken > 0 and longest < 2.0,
          f"make_whole: {broken} bonds broken by the wrap, longest after "
          f"{longest:.3f} Å")
    print(f"neighbours host paths: LeafletFinder {2 * n} lipids, cutoff 12 "
          f"Å, pbc: 'auto' {t_lf:.3f} s, 'torch' {t_lft:.3f} s, sizes "
          f"{lf.sizes()}; contact_matrix(sparse) {len(x)} oxygens at 6 Å: "
          f"{sp.nnz} entries, equal to the dense map, {t_sp:.3f} s; "
          f"make_whole {u_bonded.atoms.n_atoms} atoms: {broken} bonds broken "
          f"by the wrap, longest after {longest:.3f} Å, {t_mw:.3f} s on "
          f"{card}")


def phase_neighbours(card):
    """Phase 11: neighbour search and what it unblocks, at config 4's
    width.  Launches neither hand kernel (its paths are torch ops)."""
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    t_phase = time.perf_counter()
    before = kernel_counts()
    u = make_water_universe(n_waters=RDF_WATERS, box=RDF_BOX, n_frames=1,
                            seed=0)
    x = u.atoms.positions.astype(np.float64)
    dims = np.asarray(u.trajectory.ts.dimensions, np.float64)
    cell_list_leg(card, "self", x, x, dims, NS_CUTOFF, self_query=True)
    ox = x[u.select_atoms("name OW").indices]
    cell_list_leg(card, "cross", ox, x, dims, NS_CUTOFF,
                  min_cutoff=NS_MIN_CUTOFF)
    guess_bonds_leg(card, u)
    hbond_leg(card)
    host_legs(card, u)
    check(kernel_counts() == before,
          f"phase 11 launched a hand kernel: {before} -> {kernel_counts()}")
    print(f"neighbour phase: {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")


# ---------------------------------------------------------------- phase 12

def an_kw(bs):
    return dict(backend="torch", device=AN_DEVICE, batch_size=bs)


def tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_equal(a, b):
    """Leaf-for-leaf bit equality of two partials trees."""
    import torch

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor)
        else np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(la, lb))


def same(a, b):
    """Bit equality of two host arrays (NaNs equal where they sit)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        return np.array_equal(a, b, equal_nan=True)
    return np.array_equal(a, b)


class counting_stages:
    """Count the blocks a run stages from ``u``'s reader
    (``stage_block`` calls) with the host stage cache off, so every
    pass stages its blocks anew: ``with counting_stages(u) as n:``,
    then ``n[0]``."""

    def __init__(self, u):
        self.cls = type(u.trajectory)
        self.n = [0]

    def __enter__(self):
        orig = self.cls.stage_block
        n = self.n

        def stage_block(reader, *a, **k):
            n[0] += 1
            return orig(reader, *a, **k)

        self.orig = orig
        self.env = os.environ.get("MDTPU_HOST_STAGE_CACHE_MB")
        os.environ["MDTPU_HOST_STAGE_CACHE_MB"] = "0"
        self.cls.stage_block = stage_block
        return self.n

    def __exit__(self, *exc):
        self.cls.stage_block = self.orig
        if self.env is None:
            os.environ.pop("MDTPU_HOST_STAGE_CACHE_MB", None)
        else:
            os.environ["MDTPU_HOST_STAGE_CACHE_MB"] = self.env
        return False


def collection_leg(card, u, label, makers):
    """Phase 12 (a): ``AnalysisCollection`` of ``makers``' analyses on
    phase 4's system at float32 staging, B = 512, against each child run
    alone: every child's partials equal to its solo run's (the union is
    each child's own selection, so the ops are the same), the
    collection staging each block once (4, where the solo runs stage
    8), then a first run and three repeats over one block cache, all
    equal, the third replaying a captured graph."""
    from mdanalysis_mpi_tpu_torch.analysis import AnalysisCollection
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache

    kw = an_kw(E2E_BATCH)
    n_blocks = -(-E2E_FRAMES // E2E_BATCH)
    names = [type(m()).__name__ for m in makers]
    solos, solo_walls = [], []
    with counting_stages(u) as staged:
        for make in makers:
            a, wall = timed(lambda: make().run(**kw))
            solos.append(a)
            solo_walls.append(wall)
        n_solo, staged[0] = staged[0], 0
        coll, wall = timed(lambda: AnalysisCollection(
            *[m() for m in makers]).run(**kw))
        n_coll = staged[0]
    check(n_coll == n_blocks and n_solo == n_blocks * len(makers),
          f"collection {label}: staged {n_coll} blocks (solo runs "
          f"{n_solo}), expected {n_blocks} (solo {n_blocks * len(makers)})")
    for name, child, solo in zip(names, coll.analyses, solos):
        check(tree_equal(child._last_total, solo._last_total),
              f"collection {label}: {name} differs from its solo run")
    solo_text = " + ".join(f"{n} {w:.3f} s" for n, w in zip(names,
                                                             solo_walls))
    print(f"collection {label} {names}: {E2E_FRAMES} frames x "
          f"{len(u.select_atoms('heavy'))} atoms, float32, B={E2E_BATCH}: "
          f"wall {wall:.3f} s ({E2E_FRAMES / wall:.1f} frames/s), "
          f"{n_coll} blocks staged; solo {solo_text} = "
          f"{sum(solo_walls):.3f} s, {n_solo} blocks staged; every child "
          f"equal to its solo run on {card}")
    cache = DeviceBlockCache()
    for leg in SCAN_LEGS:
        g0 = graph_counts()
        c, w = timed(lambda: AnalysisCollection(*[m() for m in makers]).run(
            block_cache=cache, scan_k="auto", **kw))
        g = count_delta(g0, graph_counts())
        check(all(tree_equal(x._last_total, y._last_total)
                  for x, y in zip(c.analyses, coll.analyses)),
              f"collection {label}: cached {leg} not equal to the first run")
        print(f"collection {label} over one block cache, {leg}: wall "
              f"{w:.3f} s ({E2E_FRAMES / w:.1f} frames/s), graphs captured "
              f"{g['graph_misses']}, replayed {g['replays']}, equal")
    check(g["replays"] > 0 and g["graph_misses"] == 0,
          f"collection {label}: the third repeat replayed no captured "
          f"graph ({g})")
    del cache


def an_leg(card, label, make, n_frames, bs, keys, compare, tol, series=True):
    """One analysis on the card over ``n_frames`` frames, twice (the
    repeat bit-identical in every key of ``keys``), held to the serial
    float64 oracle over the first ``AN_ORACLE`` frames: the first rows
    of the device run for a time series, a device run over the same
    frames for a reduction.  ``compare(device, serial)`` → (error text,
    within ``tol``)."""
    kw = an_kw(bs)
    t_leg = time.perf_counter()

    def run(stop):
        a = make().run(stop=stop, **kw)
        return a, {k: np.asarray(getattr(a.results, k)) for k in keys}

    (a, got), wall = timed(lambda: run(n_frames))
    (_, again), wall2 = timed(lambda: run(n_frames))
    for k in keys:
        check(same(got[k], again[k]),
              f"{label}: repeat not bit-identical in {k}")
    n_o = min(AN_ORACLE, n_frames)
    t_ser = time.perf_counter()
    ser = make().run(stop=n_o, backend="serial")
    want = {k: np.asarray(getattr(ser.results, k)) for k in keys}
    t_ser = time.perf_counter() - t_ser
    dev = ({k: got[k][:n_o] for k in keys} if series
           else run(n_o)[1])
    err, ok = compare(dev, want)
    print(f"analyses {label}: {n_frames} frames, batch {bs}: wall "
          f"{wall:.3f} s ({n_frames / wall:.1f} frames/s, the results read "
          f"back), repeat {wall2:.3f} s bit-identical; vs serial float64 "
          f"over {n_o} frames ({t_ser:.2f} s): {err} (limit {tol}); leg "
          f"{time.perf_counter() - t_leg:.2f} s on {card}")
    check(ok, f"{label}: {err} against the serial oracle (limit {tol})")
    return a


def wrapped(d, period):
    """|difference| of angles modulo ``period``."""
    d = np.abs(np.asarray(d, np.float64))
    return np.minimum(d, period - d % period)


def max_abs(key, tol, period=None, rel=False):
    """A compare of ``key``: the largest |device − serial| (relative to
    the serial value if ``rel``; modulo ``period`` for angles)."""
    def compare(dev, want):
        d = np.asarray(dev[key], np.float64) - want[key]
        if rel:
            d = d / want[key]
        d = wrapped(d, period) if period else np.abs(d)
        return f"max |d {key}| {d.max():.3g}", d.max() <= tol

    return compare


def compare_helanal(dev, want):
    """Rises within 1e-4 Å; twists within 1e-3° scaled by sin(twist):
    arccos amplifies a float32 cosine's rounding by 1/sin, so a twist
    near 0° or 180° is held in cosine space (|d twist|·sin(twist))."""
    dr = np.abs(dev["local_rises"] - want["local_rises"]).max()
    tw = want["local_twists"]
    dt = np.abs(dev["local_twists"] - tw)
    dc = (dt * np.sin(np.radians(tw))).max()
    return (f"max |d rise| {dr:.3g} A, max |d twist|·sin(twist) {dc:.3g} "
            f"deg (max |d twist| {dt.max():.3g} deg)",
            dr <= 1e-4 and dc <= 1e-3)


def compare_pca(dev, want):
    top = float(want["variance"][0])
    d = np.abs(dev["variance"] - want["variance"]).max()
    return (f"max |d variance| {d:.3g} of top variance {top:.4g} "
            f"({d / top:.3g} of it)", d <= 1e-2 * top)


def compare_dssp(dev, want):
    agree = float((dev["dssp"] == want["dssp"]).mean())
    return f"agreement {agree:.5f}", agree >= 0.98


def compare_bat(n_quads):
    """BAT vectors within 1e-4 (tests/test_bat.py), the periodic columns
    (φ, ω and the torsions, in radians) modulo 2π."""
    def compare(dev, want):
        d = np.abs(np.asarray(dev["bat"], np.float64) - want["bat"])
        for cols in ([3], [5], slice(9 + 2 * n_quads, None)):
            d[:, cols] = wrapped(d[:, cols], 2 * np.pi)
        return f"max |d bat| {d.max():.3g}", d.max() <= 1e-4

    return compare


def compare_persistence(dev, want):
    d = np.abs(dev["bond_autocorrelation"]
               - want["bond_autocorrelation"]).max()
    dl = abs(float(dev["lb"]) / float(want["lb"]) - 1.0)
    return (f"max |d C(n)| {d:.3g}, lb {dl:.3g} relative",
            d <= 1e-5 and dl <= 1e-5)


def make_janin_universe(n_res, n_frames, seed):
    """The JAX tests' Janin fixture (tests/test_dihedrals.py: residues
    with N, CA, CB, CG, CD and χ₁ set by placing CG) widened to
    ``n_res`` residues with χ₁ drawn per residue and 0.05 Å of noise
    per frame."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    rng = np.random.default_rng(seed)
    coords = []
    for i in range(n_res):
        phi = np.radians(rng.uniform(-180.0, 180.0))
        n = np.array([8.0 * i, 0.0, 0.0])
        ca = n + [1.5, 0.0, 0.0]
        cb = ca + [0.0, 1.5, 0.0]
        cg = cb + 1.5 * np.array([-np.cos(phi), 0.0, np.sin(phi)])
        cd = cg + [0.0, 1.5, 0.0]
        coords += [n, ca, cb, cg, cd]
    base = np.asarray(coords, np.float32)
    frames = base[None] + rng.normal(
        scale=0.05, size=(n_frames,) + base.shape).astype(np.float32)
    top = Topology(names=np.tile(["N", "CA", "CB", "CG", "CD"], n_res),
                   resnames=np.full(5 * n_res, "LYS"),
                   resids=np.repeat(np.arange(1, n_res + 1), 5))
    return Universe(top, MemoryReader(frames))


def make_chains_universe(n_chains, beads, n_frames, seed):
    """The JAX tests' multi-chain fixture (tests/test_polymer.py: random
    walks of unit-normal steps) widened to ``n_chains`` chains."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    rng = np.random.default_rng(seed)
    n = n_chains * beads
    pos = np.cumsum(rng.normal(scale=1.0, size=(n_frames, n, 3)), axis=1)
    top = Topology(names=np.full(n, "C"), resnames=np.full(n, "POL"),
                   resids=np.arange(1, n + 1))
    u = Universe(top, MemoryReader(pos.astype(np.float32)))
    return u, [u.atoms[i * beads:(i + 1) * beads] for i in range(n_chains)]


def protein_legs(card):
    """Phase 12 (b): the protein analyses at config 1's width."""
    from mdanalysis_mpi_tpu_torch.analysis import (
        BAT, DSSP, HELANAL, PCA, GNMAnalysis, Janin, PersistenceLength,
        RadiusOfGyration, Ramachandran)
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    t0 = time.perf_counter()
    u = make_protein_universe(n_residues=AN_RESIDUES, n_frames=AN_FRAMES,
                              noise=0.3, seed=1)
    prot = u.select_atoms("protein")
    n_ca = len(u.select_atoms("name CA"))
    print(f"analyses: protein of {u.atoms.n_atoms} atoms ({AN_RESIDUES} "
          f"residues) x {AN_FRAMES} frames, built in "
          f"{time.perf_counter() - t0:.1f} s")
    an_leg(card, "RadiusOfGyration(protein)", lambda: RadiusOfGyration(prot),
           AN_FRAMES, AN_BATCH, ("rgyr",), max_abs("rgyr", 1e-5, rel=True),
           "1e-5 relative")
    an_leg(card, "Ramachandran(protein)", lambda: Ramachandran(prot),
           AN_FRAMES, AN_BATCH, ("angles",),
           max_abs("angles", 0.15, period=360.0), "0.15 deg")
    an_leg(card, "HELANAL(name CA)", lambda: HELANAL(u, select="name CA"),
           AN_FRAMES, AN_BATCH, ("local_twists", "local_rises"),
           compare_helanal, "1e-4 A, 1e-3 deg")
    an_leg(card, f"PCA(name CA, align=True, n_components=8): "
           f"{3 * n_ca}x{3 * n_ca} covariance",
           lambda: PCA(u, select="name CA", align=True, n_components=8),
           AN_FRAMES, AN_BATCH, ("variance", "p_components"), compare_pca,
           "1e-2 of the top variance", series=False)
    gnm = an_leg(card, "GNMAnalysis(name CA)",
                 lambda: GNMAnalysis(u, select="name CA"), AN_SHORT,
                 AN_SHORT_BATCH, ("eigenvalues", "eigenvectors"),
                 max_abs("eigenvalues", 1e-2), "1e-2")
    _, base, _ = host_syncs(lambda: None)
    _, waits, _ = host_syncs(lambda: gnm.run(
        stop=AN_SHORT, **an_kw(AN_SHORT_BATCH)))
    print(f"analyses GNMAnalysis: one {AN_SHORT}-frame run "
          f"({AN_SHORT // AN_SHORT_BATCH} batches) waits on the card "
          f"{own_waits(waits, base)} times of its own ({waits}; the "
          f"batched eigh checks its solver status on the host)")
    an_leg(card, "DSSP(protein)", lambda: DSSP(u), AN_SHORT, AN_SHORT_BATCH,
           ("dssp",), compare_dssp, "agreement >= 0.98")
    t0 = time.perf_counter()
    u.atoms.guess_bonds()
    try:
        target, which = BAT(u.atoms)._ag, "the whole protein"
    except ValueError as exc:
        frag = max(u.atoms.fragments, key=lambda f: f.n_atoms)
        target = frag
        which = (f"its largest bonded fragment ({frag.n_atoms} atoms; the "
                 f"whole protein: {exc})")
    n_quads = len(BAT(target)._quads_global)
    print(f"analyses BAT: guess_bonds and the torsion tree in "
          f"{time.perf_counter() - t0:.2f} s; BAT over {which}")
    an_leg(card, f"BAT({target.n_atoms} atoms)", lambda: BAT(target),
           AN_SHORT, AN_BATCH, ("bat",), compare_bat(n_quads),
           "1e-4, angles modulo 2 pi")
    uj = make_janin_universe(JANIN_RESIDUES, AN_SHORT, seed=2)
    an_leg(card, f"Janin({JANIN_RESIDUES} residues)", lambda: Janin(uj.atoms),
           AN_SHORT, AN_BATCH, ("angles",),
           max_abs("angles", 1e-3, period=360.0), "1e-3 deg")
    _, chains = make_chains_universe(POLY_CHAINS, POLY_BEADS, AN_SHORT,
                                     seed=41)
    an_leg(card, f"PersistenceLength({POLY_CHAINS} chains of {POLY_BEADS})",
           lambda: PersistenceLength(chains), AN_SHORT, AN_BATCH,
           ("bond_autocorrelation", "lb"), compare_persistence,
           "1e-5, lb 1e-5 relative", series=False)


def voxel_counts(frames, origin, inv_delta, shape, dtype):
    """Host twin of DensityAnalysis' counts, in ``dtype`` arithmetic:
    (per-voxel counts + the out-of-grid count, samples within 1e-4 of a
    voxel edge in float64)."""
    nx, ny, nz = shape
    counts = np.zeros(nx * ny * nz + 1, np.int64)
    edge = 0
    o, s = origin.astype(dtype), dtype(inv_delta)
    for x in frames:
        f = (x.astype(dtype) - o) * s
        ijk = np.floor(f)
        inside = ((ijk >= 0).all(1) & (ijk[:, 0] < nx) & (ijk[:, 1] < ny)
                  & (ijk[:, 2] < nz))
        k = ijk.astype(np.int64)
        flat = np.where(inside, k[:, 0] * ny * nz + k[:, 1] * nz + k[:, 2],
                        nx * ny * nz)
        counts += np.bincount(flat, minlength=len(counts))
        f64 = (x.astype(np.float64) - origin) * inv_delta
        edge += int((np.abs(f64 - np.round(f64)) < 1e-4).any(1).sum())
    return counts, edge


def solvent_legs(card, uw, ow):
    """Phase 12 (c): EinsteinMSD, DensityAnalysis and LinearDensity of
    phase 5's water box."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import (DensityAnalysis,
                                                   EinsteinMSD,
                                                   LinearDensity)

    n_f, n_ow = uw.trajectory.n_frames, ow.n_atoms

    def compare_msd(dev, want):
        w = want["timeseries"]
        d = np.abs(dev["timeseries"] - w)
        lim = 1e-3 * np.abs(w) + 1e-2 * float(w.max())
        return f"max |d msd| {d.max():.3g} A^2", bool((d <= lim).all())

    an_leg(card, f"EinsteinMSD(name OW, fft): {n_ow} waters",
           lambda: EinsteinMSD(uw, select="name OW"), n_f, RDF_BATCH,
           ("timeseries", "msds_by_particle"), compare_msd,
           "1e-3 relative + 1e-2 of the largest", series=False)

    kw = an_kw(RDF_BATCH)
    runs = []
    for _ in range(2):
        a, wall = timed(lambda: DensityAnalysis(ow, delta=DENSITY_DELTA)
                        .run(**kw))
        grid = np.asarray(a.results.grid)
        runs.append((a, wall, grid))
    (a, wall, grid), (b, wall2, grid2) = runs
    check(torch.equal(a._last_total[1], b._last_total[1]) and same(grid, grid2),
          "DensityAnalysis: repeat not bit-identical")
    dev = a._last_total[1].cpu().numpy().astype(np.int64)
    s = DensityAnalysis(ow, delta=DENSITY_DELTA).run(backend="serial")
    ser = np.rint(np.asarray(s._last_total[1])).astype(np.int64)
    frames = uw.trajectory.read_block(0, n_f, sel=ow.indices)[0]
    f32, edge = voxel_counts(frames, a._origin, 1.0 / a._delta, a._shape,
                             np.float32)
    flips = int(np.abs(dev - ser).sum()) // 2
    total = n_f * n_ow
    print(f"analyses DensityAnalysis(name OW, delta={DENSITY_DELTA}): grid "
          f"{a._shape}, {n_f} frames, batch {RDF_BATCH}: wall {wall:.3f} s "
          f"({n_f / wall:.1f} frames/s), repeat {wall2:.3f} s bit-identical; "
          f"total {int(dev.sum())} of {total} samples (serial "
          f"{int(ser.sum())}), {flips} samples in another voxel than the "
          f"serial float64 oracle's ({edge} lie within 1e-4 of a voxel "
          f"edge), counts equal to the host's float32 binning: "
          f"{np.array_equal(dev, f32)} on {card}")
    check(int(dev.sum()) == total and int(ser.sum()) == total,
          f"DensityAnalysis: totals {int(dev.sum())}, {int(ser.sum())} of "
          f"{total}")
    check(np.array_equal(dev, f32),
          "DensityAnalysis: counts differ from the host float32 binning")
    check(flips <= edge, f"DensityAnalysis: {flips} voxel flips against "
          f"the serial oracle, only {edge} samples near an edge")

    uw.add_TopologyAttr("charges", np.tile(TIP3P_CHARGES,
                                           uw.atoms.n_atoms // 3))
    runs = []
    for _ in range(2):
        a, wall = timed(lambda: LinearDensity(ow, binsize=LINDENS_BINSIZE)
                        .run(**kw).results.materialize())
        runs.append((a, wall))
    (a, wall), (b, wall2) = runs
    a = runs[0][0]
    keys = ("mass_density", "mass_density_stddev", "charge_density",
            "charge_density_stddev")
    check(all(same(getattr(a[ax], k), getattr(b[ax], k))
              for ax in "xyz" for k in keys),
          "LinearDensity: repeat not bit-identical")
    s = LinearDensity(ow, binsize=LINDENS_BINSIZE).run(
        backend="serial").results
    err = max(float(np.abs(getattr(a[ax], k) - getattr(s[ax], k)).max())
              for ax in "xyz" for k in ("mass_density", "charge_density"))
    print(f"analyses LinearDensity(name OW, binsize={LINDENS_BINSIZE}, "
          f"TIP3P charges): {a['nbins']} bins, {n_f} frames, batch "
          f"{RDF_BATCH}: wall {wall:.3f} s ({n_f / wall:.1f} frames/s), "
          f"repeat {wall2:.3f} s bit-identical; vs serial float64: max |d| "
          f"{err:.3g} (limit 5e-2) on {card}")
    check(err <= 5e-2, f"LinearDensity: {err:.3g} against the serial oracle")


def phase_analyses(card, u_e2e, uw, ow):
    """Phase 12: the generic analysis API and the analyses of ROADMAP A8
    on the card.  Launches neither hand kernel (torch ops)."""
    from mdanalysis_mpi_tpu_torch.analysis import (RMSD, RMSF,
                                                   AverageStructure,
                                                   RadiusOfGyration)

    t_phase = time.perf_counter()
    before = kernel_counts()
    heavy = u_e2e.select_atoms("heavy")
    collection_leg(card, u_e2e, "of reductions", [
        lambda: RMSF(heavy),
        lambda: AverageStructure(u_e2e, select="heavy", select_only=True)])
    collection_leg(card, u_e2e, "of series", [
        lambda: RMSD(u_e2e, select="heavy"),
        lambda: RadiusOfGyration(heavy)])
    protein_legs(card)
    solvent_legs(card, uw, ow)
    check(kernel_counts() == before,
          f"phase 12 launched a hand kernel: {before} -> {kernel_counts()}")
    print(f"analysis phase: {time.perf_counter() - t_phase:.1f} s on {card}")


# ---------------------------------------------------------------- phase 13

def distance_matrix_leg(card, u):
    """Phase 13 (a): DistanceMatrix at its 4,096-frame cap, then
    DiffusionMap of the matrix → the run (its Cα trajectory is (b)'s
    and (c)'s input)."""
    from mdanalysis_mpi_tpu_torch.analysis import DiffusionMap, DistanceMatrix

    kw = dict(backend="torch", device="cuda", batch_size=DM_BATCH)

    def run():
        dm = DistanceMatrix(u, select="name CA").run(**kw)
        return dm, dm.results.dist_matrix

    (dm, m), wall = timed(run)
    (_, m2), wall2 = timed(run)
    check(same(m, m2), "DistanceMatrix: repeat not bit-identical")
    t = DM_FRAMES
    check(m.shape == (t, t) and bool(np.isfinite(m).all()),
          f"DistanceMatrix: shape {m.shape}, finite {np.isfinite(m).all()}")
    check(np.array_equal(m, m.T) and not np.diag(m).any(),
          "DistanceMatrix: not symmetric with a zero diagonal")
    _, base, _ = host_syncs(lambda: None)
    _, w_run, d_run = host_syncs(
        lambda: DistanceMatrix(u, select="name CA").run(**kw))
    _, w_read, d_read = host_syncs(run)
    t_ser = time.perf_counter()
    s = DistanceMatrix(u, select="name CA").run(
        stop=DM_ORACLE, backend="serial").results.dist_matrix
    t_ser = time.perf_counter() - t_ser
    err = float(np.abs(m[:DM_ORACLE, :DM_ORACLE] - s).max())
    eps = float(np.median(m)) ** 2
    dmap, t_map = timed(lambda: DiffusionMap(dm, epsilon=eps).run())
    vals = dmap.results.eigenvalues
    emb = dmap.transform(3)
    n_sel = len(u.select_atoms("name CA"))
    pairs = t * (t - 1) // 2
    print(f"remaining analyses DistanceMatrix(name CA): {n_sel} atoms x {t} "
          f"frames, batch {DM_BATCH}, {pairs} Kabsch problems: wall "
          f"{wall:.3f} s ({pairs / wall:.4g} pairs/s, the matrix read "
          f"back), repeat {wall2:.3f} s bit-identical; a run() waits on the "
          f"card {own_waits(w_run, base)} times ({d_run} copies to the "
          f"host), run and first read {own_waits(w_read, base)} ({d_read} "
          f"copies); vs serial float64 over {DM_ORACLE} frames "
          f"({t_ser:.2f} s): max |d| {err:.3g} A (parity limit {DM_TOL}, "
          f"float64 limit {DM_F64_TOL}) on {card}")
    check(err <= DM_TOL, f"DistanceMatrix: {err:.3g} A against the serial "
          f"oracle (limit {DM_TOL})")
    # the device route is float64 throughout (products and QCP): float32
    # products or fewer Newton steps would show far above this
    check(err <= DM_F64_TOL, f"DistanceMatrix: {err:.3g} A against the "
          f"serial float64 loop (the float64 route's limit {DM_F64_TOL})")
    print(f"remaining analyses DiffusionMap(epsilon={eps:.4g}) of the "
          f"{t}x{t} matrix (host eigh): {t_map:.3f} s; top eigenvalues "
          f"{vals[0]:.12f} {vals[1]:.6f} {vals[2]:.6f}, embedding "
          f"{emb.shape} on {card}")
    check(abs(vals[0] - 1.0) <= 1e-8 and bool(np.isfinite(emb).all()),
          f"DiffusionMap: top eigenvalue {vals[0]!r}, embedding finite "
          f"{np.isfinite(emb).all()}")


def psa_leg(card, ca_frames):
    """Phase 13 (b): PSAnalysis of eight 512-frame windows, both
    metrics on the card."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import (PSAnalysis,
                                                   discrete_frechet,
                                                   hausdorff)
    from mdanalysis_mpi_tpu_torch.analysis.psa import (_frechet_np,
                                                       cross_rmsd,
                                                       frechet_wavefront)

    paths = [ca_frames[k * PSA_FRAMES:(k + 1) * PSA_FRAMES]
             for k in range(PSA_PATHS)]
    psa, t_align = timed(lambda: PSAnalysis(paths, align=True))
    n_pairs = PSA_PATHS * (PSA_PATHS - 1) // 2
    for metric, host_fn in (("hausdorff", hausdorff),
                            ("discrete_frechet", discrete_frechet)):
        def run():
            return psa.run(metric=metric, backend="torch",
                           device="cuda").results.D

        d, wall = timed(run)
        d2, wall2 = timed(run)
        check(same(d, d2), f"PSA {metric}: repeat not bit-identical")
        check(bool(np.isfinite(d).all()) and not np.diag(d).any(),
              f"PSA {metric}: matrix not finite with a zero diagonal")
        t_ser = time.perf_counter()
        errs = [abs(d[i, j] - host_fn(psa._paths[i], psa._paths[j]))
                for i, j in PSA_PAIRS]
        t_ser = time.perf_counter() - t_ser
        err = float(max(errs))
        print(f"remaining analyses PSAnalysis({metric}): {PSA_PATHS} paths "
              f"of {PSA_FRAMES} frames x {paths[0].shape[1]} atoms "
              f"({n_pairs} pairs, host alignment {t_align:.2f} s): wall "
              f"{wall:.3f} s, repeat {wall2:.3f} s bit-identical; pairs "
              f"{list(PSA_PAIRS)} vs serial float64 ({t_ser:.2f} s): max "
              f"|d| {err:.3g} (limit 0.05) on {card}")
        check(err <= 0.05, f"PSA {metric}: {err:.3g} against the serial "
              "metric (limit 0.05)")
    for i, j in PSA_PAIRS:
        p = torch.as_tensor(np.asarray(psa._paths[i], np.float32),
                            device="cuda")
        q = torch.as_tensor(np.asarray(psa._paths[j], np.float32),
                            device="cuda")
        m = cross_rmsd(p, q)
        got = float(frechet_wavefront(m))
        want = _frechet_np(m.cpu().numpy())
        check(got == want, f"PSA: the wavefront {got!r} differs from the "
              f"host recurrence {want!r} on the card's cross matrix of "
              f"pair ({i}, {j})")
    print(f"remaining analyses PSA: the Frechet wavefront equals the host "
          f"recurrence on the card's cross matrices of pairs "
          f"{list(PSA_PAIRS)} on {card}")


def encore_leg(card, ca_frames):
    """Phase 13 (c): encore on two 256-frame ensembles."""
    from mdanalysis_mpi_tpu_torch.analysis import ces, dres, hes
    from mdanalysis_mpi_tpu_torch.analysis.encore import (
        LN2, conformational_distance_matrix)
    from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd

    e1 = ca_frames[:ENC_FRAMES]
    e2 = ca_frames[DM_FRAMES // 2:DM_FRAMES // 2 + ENC_FRAMES]
    joint = np.concatenate([e1, e2]).astype(np.float64)
    d, wall = timed(lambda: conformational_distance_matrix(joint, "cuda"))
    d2, wall2 = timed(lambda: conformational_distance_matrix(joint, "cuda"))
    check(same(d, d2), "encore distance matrix: repeat not bit-identical")
    idx = list(range(ENC_ORACLE)) + list(range(ENC_FRAMES,
                                               ENC_FRAMES + ENC_ORACLE))
    t_ser = time.perf_counter()
    x = joint.astype(np.float32)
    err = 0.0
    for a, i in enumerate(idx):
        for j in idx[a + 1:]:
            err = max(err, abs(d[i, j] - rmsd(x[j], x[i],
                                              superposition=True)))
    t_ser = time.perf_counter() - t_ser
    print(f"remaining analyses encore conformational_distance_matrix: "
          f"{len(joint)} frames x {joint.shape[1]} atoms: wall {wall:.3f} "
          f"s, repeat {wall2:.3f} s bit-identical; vs the serial Kabsch "
          f"loop over {ENC_ORACLE} frames of each ensemble ({t_ser:.2f} "
          f"s): max |d| {err:.3g} A (limit 5e-3) on {card}")
    check(err <= 5e-3, f"encore distance matrix: {err:.3g} A against the "
          "serial loop (limit 5e-3)")
    (dh, _), t_h = timed(lambda: hes([e1, e2]))
    (dc, _), t_c = timed(lambda: ces([e1, e2], device="cuda"))
    (dd, _), t_d = timed(lambda: dres([e1, e2], device="cuda"))
    print(f"remaining analyses encore, two ensembles of {ENC_FRAMES} "
          f"frames: hes {dh[0, 1]:.6g} ({t_h:.2f} s), ces {dc[0, 1]:.6g} "
          f"({t_c:.2f} s), dres {dd[0, 1]:.6g} ({t_d:.2f} s) on {card}")
    check(bool(np.isfinite(dh).all()) and dh.min() >= 0.0
          and np.array_equal(dh, dh.T),
          f"hes: {dh} not finite, non-negative and symmetric")
    for name, v in (("ces", dc), ("dres", dd)):
        check(bool(np.isfinite(v).all()) and v.min() >= 0.0
              and v.max() <= LN2, f"{name}: {v} outside [0, ln 2]")


def ar1_velocities(n_at):
    """VACF_FRAMES frames of seeded AR(1) velocities of ``n_at`` atoms
    (4 Å/ps, 0.9 a frame): phase 13's VelocityAutocorr input, written to
    files in phase 14."""
    rng = np.random.default_rng(13)
    vel = np.empty((VACF_FRAMES, n_at, 3), np.float32)
    v = rng.normal(scale=4.0, size=(n_at, 3))
    for f in range(VACF_FRAMES):
        v = 0.9 * v + np.sqrt(1.0 - 0.81) * rng.normal(scale=4.0,
                                                       size=(n_at, 3))
        vel[f] = v
    return vel


def water_legs(card, uw, ow):
    """Phase 13 (d): WOR, AngularDistribution, DielectricConstant and
    VelocityAutocorr on phase 5's water box."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import (
        AngularDistribution, DielectricConstant, VelocityAutocorr,
        WaterOrientationalRelaxation)
    from mdanalysis_mpi_tpu_torch.analysis.vacf import _np_fft_vacf
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    kw = dict(backend="torch", device="cuda", batch_size=RDF_BATCH)
    n_f, n_w = uw.trajectory.n_frames, ow.n_atoms
    for label, make, key, tol in (
            (f"WaterOrientationalRelaxation(dtmax={WOR_DTMAX})",
             lambda: WaterOrientationalRelaxation(uw, "name OW",
                                                  dtmax=WOR_DTMAX),
             "timeseries", 1e-5),
            ("AngularDistribution(bins=40)",
             lambda: AngularDistribution(uw, "name OW"), "dip", 1e-4)):
        keys = (key,) if key == "timeseries" else ("OH", "HH", "dip")

        def run(stop=None, **k):
            a = make().run(stop=stop, **(k or kw))
            return {x: np.asarray(getattr(a.results, x)) for x in keys}

        got, wall = timed(run)
        again, wall2 = timed(run)
        check(all(same(got[x], again[x]) for x in keys),
              f"{label}: repeat not bit-identical")
        t_ser = time.perf_counter()
        want = run(WATER_ORACLE, backend="serial")
        t_ser = time.perf_counter() - t_ser
        dev = run(WATER_ORACLE)
        err = max(float(np.abs(dev[x] - want[x]).max()) for x in keys)
        print(f"remaining analyses {label}: {n_w} waters x {n_f} frames, "
              f"batch {RDF_BATCH}: wall {wall:.3f} s ({n_f / wall:.1f} "
              f"frames/s, results read back), repeat {wall2:.3f} s "
              f"bit-identical; vs serial float64 over {WATER_ORACLE} frames "
              f"({t_ser:.2f} s): max |d| {err:.3g} (limit {tol}) on {card}")
        check(err <= tol, f"{label}: {err:.3g} against the serial oracle "
              f"(limit {tol})")

    if uw.topology.charges is None:
        uw.add_TopologyAttr("charges", np.tile(TIP3P_CHARGES, n_w))
    want = DielectricConstant(uw.atoms, make_whole=False).run(
        backend="serial").results
    for label, run_kw in (("TorchExecutor", kw),
                          ("the mesh over the card",
                           dict(backend="mesh", batch_size=RDF_BATCH))):
        def run():
            r = DielectricConstant(uw.atoms, make_whole=False).run(
                **run_kw).results
            return np.asarray(r.eps), float(r.eps_mean)

        (eps, eps_mean), wall = timed(run)
        (eps2, eps_mean2), wall2 = timed(run)
        check(same(eps, eps2) and eps_mean == eps_mean2,
              f"DielectricConstant on {label}: repeat not bit-identical")
        rel = max(float(np.abs(eps / want.eps - 1.0).max()),
                  abs(eps_mean / want.eps_mean - 1.0))
        print(f"remaining analyses DielectricConstant(TIP3P, "
              f"make_whole=False) on {label}: {uw.atoms.n_atoms} atoms x "
              f"{n_f} frames: wall {wall:.3f} s, repeat {wall2:.3f} s "
              f"bit-identical; eps_mean {eps_mean:.6g} vs serial "
              f"{want.eps_mean:.6g}: max relative |d| {rel:.3g} (limit "
              f"1e-3) on {card}")
        check(rel <= 1e-3, f"DielectricConstant on {label}: {rel:.3g} "
              "relative to serial (limit 1e-3)")

    t0 = time.perf_counter()
    n_at = uw.atoms.n_atoms
    vel = ar1_velocities(n_at)
    uv = Universe(uw.topology, MemoryReader(
        np.zeros((VACF_FRAMES, n_at, 3), np.float32), velocities=vel))
    t_build = time.perf_counter() - t0

    def run():
        r = VelocityAutocorr(uv.atoms).run(backend="torch", device="cuda")
        return np.asarray(r.results.vacf_by_particle)

    by, wall = timed(run)
    by2, wall2 = timed(run)
    check(same(by, by2), "VelocityAutocorr: repeat not bit-identical")
    t_ser = time.perf_counter()
    want = _np_fft_vacf(vel[:, ::VACF_STRIDE])
    t_ser = time.perf_counter() - t_ser
    got = by[:, ::VACF_STRIDE]
    err = float(np.abs(got - want).max() / np.abs(want).max())
    # test_vacf.py's gate: rtol on the timeseries (the particles' mean),
    # over the lags where C stays well above its sampling noise
    ts_got, ts_want = got.mean(axis=1), want.mean(axis=1)
    lags = np.abs(ts_want) >= VACF_FLOOR * abs(ts_want[0])
    rel = float((np.abs(ts_got - ts_want)[lags]
                 / np.abs(ts_want[lags])).max())
    print(f"remaining analyses VelocityAutocorr: {n_at} atoms x "
          f"{VACF_FRAMES} frames of AR(1) velocities (built in "
          f"{t_build:.1f} s): wall {wall:.3f} s (host frame reads "
          f"included), repeat {wall2:.3f} s, bit-identical "
          f"{same(by, by2)}; float32 FFT vs the float64 _np_fft_vacf of "
          f"every {VACF_STRIDE}th atom ({t_ser:.2f} s): max |d| / max |C| "
          f"{err:.3g} (limit 1e-3); their timeseries over the "
          f"{int(lags.sum())} of {lags.size} lags with |C| >= {VACF_FLOOR} "
          f"C(0): max relative |d| {rel:.3g} (limit {VACF_RTOL}) on {card}")
    check(err <= 1e-3, f"VelocityAutocorr: {err:.3g} of the largest |C| "
          "against the float64 FFT (limit 1e-3)")
    check(rel <= VACF_RTOL, f"VelocityAutocorr: timeseries {rel:.3g} "
          f"relative to the float64 FFT (limit {VACF_RTOL})")


def cli_leg(card):
    """Phase 13 (e): ``python -m mdanalysis_mpi_tpu_torch`` on config
    1's PSF/DCD in a subprocess against the same run in process."""
    import tempfile

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF

    with tempfile.TemporaryDirectory() as tmp:
        psf, dcd, _ = write_config1(tmp)
        out = os.path.join(tmp, "rmsf.npz")
        cmd = [sys.executable, "-m", "mdanalysis_mpi_tpu_torch",
               "aligned-rmsf", psf, dcd, "--select", "name CA",
               "--output", out]
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=tmp, timeout=600)
        t_cli = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        check(summary["backend"] == "torch" and summary["n_frames"] == 98,
              f"CLI summary {summary}")
        got = np.load(out)["rmsf"]
        want = AlignedRMSF(Universe(psf, dcd), select="name CA").run(
            backend="torch", device="cuda").results.rmsf
        err = float(np.abs(got - want).max())
        print(f"remaining analyses CLI: python -m mdanalysis_mpi_tpu_torch "
              f"aligned-rmsf PSF DCD ({got.shape[0]} CA x 98 frames): "
              f"process {t_cli:.2f} s, its run wall {summary['wall_s']} s on "
              f"backend {summary['backend']} (timed phases of the run: "
              f"{summary['phases']}); npz rmsf vs the in-process "
              f"run: max |d| {err:.3g} A (limit {CLI_TOL}) on {card}")
        check(err <= CLI_TOL, f"CLI rmsf {err:.3g} A from the in-process "
              f"run (limit {CLI_TOL})")


def phase_remaining(card, uw, ow):
    """Phase 13: the last A8 analyses and the command line on the card.
    Launches neither hand kernel (torch ops)."""
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    t_phase = time.perf_counter()
    before = kernel_counts()
    t0 = time.perf_counter()
    u = make_protein_universe(n_residues=AN_RESIDUES, n_frames=DM_FRAMES,
                              noise=0.3, seed=1)
    ca_frames = u.trajectory.read_block(
        0, DM_FRAMES, sel=u.select_atoms("name CA").indices)[0]
    print(f"remaining analyses: protein of {u.atoms.n_atoms} atoms x "
          f"{DM_FRAMES} frames, built in {time.perf_counter() - t0:.1f} s")
    legs = (("(a) DistanceMatrix", lambda: distance_matrix_leg(card, u)),
            ("(b) PSA", lambda: psa_leg(card, ca_frames)),
            ("(c) encore", lambda: encore_leg(card, ca_frames)),
            ("(d) water", lambda: water_legs(card, uw, ow)),
            ("(e) CLI", lambda: cli_leg(card)))
    for name, leg in legs:
        t0 = time.perf_counter()
        leg()
        print(f"remaining analyses leg {name}: {time.perf_counter() - t0:.1f}"
              f" s on {card}")
    check(kernel_counts() == before,
          f"phase 13 launched a hand kernel: {before} -> {kernel_counts()}")
    print(f"remaining analyses phase: {time.perf_counter() - t_phase:.1f} s "
          f"on {card}")


# ---------------------------------------------------------------- phase 15

#: the shared device cache of phase 15's scheduler: every tenant's
#: estimate (full atom count) admitted with a reservation
SERVE_CACHE_BYTES = 16 << 30
#: the breaker leg's faulting jobs run one block each
SERVE_FAULT_STOP = 512
SERVE_TOL = 1e-5


class _WarningTap:
    """Keeps the scheduler logger's warnings (a skipped warmup or a
    failed prefetch must not pass unnoticed)."""

    def __init__(self):
        import logging

        class _Handler(logging.Handler):
            def emit(inner, record):
                self.lines.append(record.getMessage())

        self.lines = []
        self._handler = _Handler(logging.WARNING)
        self._logger = logging.getLogger("mdtpu.service")

    def __enter__(self):
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        return False


class _LaunchThreads:
    """Notes the thread of every hand-kernel launch (and every launch
    recorded into a CUDA graph capture) while active."""

    def __enter__(self):
        import threading

        from mdanalysis_mpi_tpu_torch import _build

        self.names = []
        self._orig = orig = _build.count_launch

        def counting(wrapper):
            self.names.append(threading.current_thread().name)
            orig(wrapper)

        _build.count_launch = counting
        return self

    def __exit__(self, *exc):
        from mdanalysis_mpi_tpu_torch import _build

        _build.count_launch = self._orig
        return False


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def serve_tenants(card, u, ow, tmp):
    """Phase 15 (a): four tenants on one ``Scheduler`` → fused and
    pair-histogram launches of the served run, and the served A's
    RMSF."""
    import torch

    from mdanalysis_mpi_tpu_torch import Universe, obs
    from mdanalysis_mpi_tpu_torch.analysis import (AlignedRMSF, InterRDF,
                                                   RMSD, RadiusOfGyration)
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
    from mdanalysis_mpi_tpu_torch.obs import prof
    from mdanalysis_mpi_tpu_torch.obs.alerts import AlertEngine, seed_rules
    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache
    from mdanalysis_mpi_tpu_torch.service import AnalysisJob, Scheduler
    from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

    bs = E2E_BATCH
    # tenant B reads the same frames through a reader of its own, so
    # each reader's adaptive int16 scale hints start fresh for its
    # tenant as they do for that tenant's solo run
    u_b = Universe(u.topology, MemoryReader(u.trajectory._coords))
    for x in (u, u_b):
        x.trajectory.__dict__.pop("_quant_max_hints", None)
    int16 = {"transfer_dtype": "int16"}
    jobs = {
        "A": AnalysisJob(AlignedRMSF(u, select="heavy", engine="fused"),
                         backend="torch", batch_size=bs,
                         executor_kwargs=dict(int16), priority=10,
                         tenant="A", fingerprint="A"),
        "B": AnalysisJob(AlignedRMSF(u_b, select="heavy", engine="fused"),
                         backend="mesh", batch_size=bs,
                         executor_kwargs=dict(int16), priority=5,
                         tenant="B", fingerprint="B"),
        "C-rmsd": AnalysisJob(RMSD(u, select="heavy"), backend="torch",
                              batch_size=bs, priority=1, tenant="C",
                              fingerprint="C-rmsd"),
        "C-rgyr": AnalysisJob(RadiusOfGyration(u.select_atoms("heavy")),
                              backend="torch", batch_size=bs, priority=1,
                              tenant="C", fingerprint="C-rgyr"),
        "D": AnalysisJob(InterRDF(ow, ow, engine="auto"), backend="torch",
                         batch_size=RDF_BATCH, priority=1, tenant="D",
                         fingerprint="D"),
    }
    journal = os.path.join(tmp, "serve.jsonl")
    cache = DeviceBlockCache(max_bytes=SERVE_CACHE_BYTES)
    sched = Scheduler(n_workers=1, autostart=False, cache=cache,
                      journal=journal)
    os.environ["MDTPU_PROF"] = "1"
    try:
        with _WarningTap() as tap:
            t0 = time.perf_counter()
            warm_a = sched.warmup([jobs["A"]])["executables"]
            warm_b = sched.warmup([jobs["B"]])["executables"]
            warm_r = sched.warmup([jobs[k] for k in ("C-rmsd", "C-rgyr",
                                                     "D")])["executables"]
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            handles = {k: sched.submit(j) for k, j in jobs.items()}
            t0 = time.perf_counter()
            staged = sched.prefetch_pending()
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            hits0, misses0 = cache.hits, cache.misses
            # the main path: the counts set to 0 just before the served
            # run and read just after it
            fp.planar_sums.launches = 0
            fd.pair_histogram.launches = 0
            with _LaunchThreads() as threads:
                t0 = time.perf_counter()
                sched.start()
                drained = sched.drain(timeout=900)
                torch.cuda.synchronize()
                t_serve = time.perf_counter() - t0
            fused, ph = fp.planar_sums.launches, fd.pair_histogram.launches
            stacks = len(prof.report(top=1000)["stacks"])
            served = {}
            for k, h in handles.items():
                try:
                    served[k] = h.result(timeout=0)
                except Exception as exc:
                    raise SmokeFailure(
                        f"served job {k} failed: {type(exc).__name__}: "
                        f"{exc}") from exc
            snap = sched.telemetry.snapshot()
            firing = [a["rule"] for a in sched.alerts.firing()]
            unified = obs.unified_snapshot(timers=TIMERS, cache=cache,
                                           telemetry=sched.telemetry)
    finally:
        os.environ.pop("MDTPU_PROF", None)
        prof.disable()
        sched.shutdown()
    check(drained, "phase 15's scheduler did not drain in 900 s")
    print(f"serve: warmup {t_warm:.2f} s (programs run: A {warm_a}, "
          f"B {warm_b}, C and D {warm_r}); prefetch {t_pre:.2f} s "
          f"({staged} blocks staged ahead of the claims); served run "
          f"{t_serve:.2f} s for {len(jobs)} jobs; fused launches {fused}, "
          f"pair-histogram launches {ph} on {card}")
    for k, h in handles.items():
        print(f"serve job {k}: {type(h.job.analysis).__name__} on "
              f"{h.job.backend}, queue wait {h.queue_wait_s:.3f} s, "
              f"latency {h.latency_s:.3f} s, coalesced {h.coalesced}")
    check(warm_a > 0 and warm_b > 0,
          f"warmup ran no program for the torch job ({warm_a}) or the "
          f"mesh job ({warm_b})")
    bad = [x for x in tap.lines
           if "warmup skipped" in x or "prefetch failed" in x]
    check(not bad, f"the scheduler logged {bad}")
    check(snap["prefetch_skipped"] == 0 and staged > 0
          and all(h.prefetched for h in handles.values()),
          f"prefetch staged {staged} blocks, skipped "
          f"{snap['prefetch_skipped']} units")
    check(cache.misses == misses0 and cache.hits > hits0,
          f"served passes missed the prefetched blocks: misses "
          f"{misses0} -> {cache.misses}, hits {hits0} -> {cache.hits}")
    check(fused == 16 and ph == 4,
          f"launches inside the served run: fused {fused} (expected 16), "
          f"pair histogram {ph} (expected 4)")
    check(threads.names and all(n.startswith("mdtpu-serve-")
                                for n in threads.names),
          f"hand kernels launched outside the scheduler's workers: "
          f"{sorted(set(threads.names))}")
    check(snap["coalesce_batches"] == 1 and snap["coalesced_jobs"] == 2,
          f"coalescing: {snap['coalesce_batches']} merged units of "
          f"{snap['coalesced_jobs']} jobs (expected 1 of 2)")
    check(handles["C-rmsd"].coalesced and handles["C-rgyr"].coalesced,
          "tenant C's RMSD and RadiusOfGyration did not share a pass")
    check(handles["A"].finished_t < handles["B"].finished_t,
          "tenant A (priority 10) finished after tenant B (priority 5)")
    check(snap["admission_shed_serial"] == 0 and snap["breaker_reroutes"]
          == 0, f"jobs moved off the card: shed to serial "
          f"{snap['admission_shed_serial']}, rerouted "
          f"{snap['breaker_reroutes']}")
    rec = Scheduler.recover(journal)
    check(rec["done"] == set(jobs) and not rec["pending"],
          f"journal replay: done {sorted(rec['done'])}, pending "
          f"{rec['pending']}")
    check(stacks > 0, "MDTPU_PROF=1: the profiler holds no stacks")
    eng = AlertEngine(rules=seed_rules())
    fired = [t["rule"] for i in range(3)
             for t in eng.evaluate(unified, now=float(i))
             if t["state"] == "firing"]
    check(not firing and not fired,
          f"seed alert rules fired over the scheduler's snapshot: "
          f"{firing or fired}")
    print(f"serve checks: coalesced {snap['coalesced_jobs']} jobs in "
          f"{snap['coalesce_batches']} unit; cache hits {hits0} -> "
          f"{cache.hits}, misses {cache.misses} unchanged; journal "
          f"replays {len(rec['done'])} done; profiler stacks {stacks}; "
          f"no seed alert fired; shed to serial 0")

    # each result against a solo run() of the same analysis on the card
    run_kw = dict(backend="torch", batch_size=bs)
    solos = {}

    def solo(key, make):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = make()
        torch.cuda.synchronize()
        solos[key] = time.perf_counter() - t0
        rep = r.results.get("observability")
        check(rep is not None and rep["analysis"] == type(r).__name__,
              f"solo {key} run carries no results.observability")
        return r

    u.trajectory.__dict__.pop("_quant_max_hints", None)
    sa = solo("A", lambda: AlignedRMSF(u, select="heavy", engine="fused")
              .run(transfer_dtype="int16", **run_kw))
    u_b.trajectory.__dict__.pop("_quant_max_hints", None)
    sb = solo("B", lambda: AlignedRMSF(u_b, select="heavy",
                                       engine="fused").run(
        backend="mesh", batch_size=bs, transfer_dtype="int16"))
    sd = solo("C-rmsd", lambda: RMSD(u, select="heavy").run(**run_kw))
    sg = solo("C-rgyr", lambda: RadiusOfGyration(
        u.select_atoms("heavy")).run(**run_kw))
    sr = solo("D", lambda: InterRDF(ow, ow).run(
        backend="torch", batch_size=RDF_BATCH))
    for key, got, want in (("A", served["A"], sa), ("B", served["B"], sb)):
        g, w = got.results.rmsf, want.results.rmsf
        err = float(np.abs(g - w).max())
        print(f"serve {key} vs its solo run: max |d rmsf| {err:.3g} A "
              f"(limit {SERVE_TOL}), bit-equal {np.array_equal(g, w)}")
        check(err <= SERVE_TOL, f"served {key} RMSF {err:.3g} A from its "
              "solo run")
    e_d = rel_err(served["C-rmsd"].results.rmsd, sd.results.rmsd)
    e_g = rel_err(served["C-rgyr"].results.rgyr, sg.results.rgyr)
    e_r = rel_err(served["D"].results.rdf, sr.results.rdf)
    same_counts = np.array_equal(served["D"].results.count,
                                 sr.results.count)
    print(f"serve C (coalesced) vs solo: RMSD {e_d:.3g}, Rg {e_g:.3g} "
          f"relative; D: g(r) {e_r:.3g} relative, counts equal "
          f"{same_counts} (limits {SERVE_TOL})")
    check(e_d <= SERVE_TOL and e_g <= SERVE_TOL,
          f"served C: RMSD {e_d:.3g}, Rg {e_g:.3g} relative from solo")
    check(e_r <= SERVE_TOL and same_counts,
          f"served D: g(r) {e_r:.3g} relative, counts equal {same_counts}")
    lat = sum(h.latency_s for h in handles.values())
    print(f"serve wall {t_serve:.2f} s against the solo runs' "
          f"{sum(solos.values()):.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in solos.items())
          + f"); summed job latencies {lat:.2f} s on {card}")
    cache.drop()
    return fused, ph, served["A"].results.rmsf


def serve_breaker(card, u, rmsf_served):
    """Phase 15 (b): injected kernel faults trip the torch breaker; the
    next torch job is refused (not finished on serial); after the
    cooldown the half-open probe closes the breaker and one more job
    runs on the card → its fused launches."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
    from mdanalysis_mpi_tpu_torch.reliability import breaker, faults
    from mdanalysis_mpi_tpu_torch.service import (BackendUnavailableError,
                                                  Scheduler)

    bs = E2E_BATCH
    now = [0.0]
    board = breaker.BreakerBoard(threshold=2, cooldown_s=30.0,
                                 clock=lambda: now[0])
    sched = Scheduler(n_workers=1, breakers=board)
    kw = dict(backend="torch", batch_size=bs,
              executor_kwargs={"transfer_dtype": "int16"}, coalesce=False)
    try:
        t0 = time.perf_counter()
        with faults.inject(faults.FaultSpec("kernel", "raise",
                                            times=None)):
            bad = [sched.submit(AlignedRMSF(u, select="heavy",
                                            engine="fused"),
                                stop=SERVE_FAULT_STOP,
                                tenant=f"faulty-{i}", **kw)
                   for i in range(2)]
            check(sched.drain(timeout=300), "faulting jobs did not drain")
        errs = [type(h.error).__name__ for h in bad]
        check(all(h.error is not None for h in bad),
              f"jobs under an endless kernel fault finished: {errs}")
        check(board.get("torch").state == breaker.OPEN,
              f"torch breaker {board.get('torch').state} after 2 faults")
        refused = sched.submit(AlignedRMSF(u, select="heavy",
                                           engine="fused"),
                               tenant="refused", **kw)
        check(sched.drain(timeout=300), "the refused job did not drain")
        err = refused.error
        check(isinstance(err, BackendUnavailableError)
              and err.breakers == ("torch",),
              f"with the torch breaker open the job ended "
              f"{refused.state} with {type(err).__name__}: {err}")
        check("rmsf" not in refused.job.analysis.results,
              "the refused job has a result: it ran somewhere")
        snap = sched.telemetry.snapshot()
        check(snap["breaker_reroutes"] == 0
              and snap["admission_shed_serial"] == 0,
              f"jobs moved to serial: {snap['breaker_reroutes']} "
              f"reroutes, {snap['admission_shed_serial']} sheds")
        now[0] += 31.0
        u.trajectory.__dict__.pop("_quant_max_hints", None)
        torch.cuda.synchronize()
        fp.planar_sums.launches = 0
        back = sched.submit(AlignedRMSF(u, select="heavy",
                                        engine="fused"),
                            tenant="recovered", **kw)
        check(sched.drain(timeout=300), "the recovered job did not drain")
        torch.cuda.synchronize()
        launches = fp.planar_sums.launches
        wall = time.perf_counter() - t0
    finally:
        sched.shutdown()
    check(back.error is None, f"after the cooldown the job failed: "
          f"{type(back.error).__name__}: {back.error}")
    br = board.get("torch")
    check(br.state == breaker.CLOSED and br.probes == 1,
          f"torch breaker {br.state} after {br.probes} probes")
    check(launches == 8, f"the recovered job launched the fused kernel "
          f"{launches} times (expected 8)")
    err = float(np.abs(back.result().results.rmsf - rmsf_served).max())
    print(f"serve breaker: 2 kernel faults ({errs}) opened the torch "
          f"breaker; the next job was refused ({type(refused.error).__name__}"
          f", never run on serial); after the cooldown the half-open probe "
          f"closed it and the job ran with {launches} fused launches, "
          f"RMSF {err:.3g} A from the served A; leg {wall:.1f} s on {card}")
    check(err <= SERVE_TOL, f"recovered job's RMSF {err:.3g} A from A's")
    return launches


def serve_batch_cli(card, tmp):
    """Phase 15 (c): ``python -m mdanalysis_mpi_tpu_torch batch`` on
    config 1's PSF/DCD against the same three runs in process."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.utils.config import (AnalysisConfig,
                                                       build_analysis)

    psf, dcd, _ = write_config1(tmp)
    specs = [{"analysis": "aligned-rmsf", "engine": "fused",
              "transfer_dtype": "int16", "tenant": "a"},
             {"analysis": "rmsd", "tenant": "d"},
             {"analysis": "rgyr", "tenant": "g"}]
    keys = ("rmsf", "rmsd", "rgyr")
    for s in specs:
        s["output"] = os.path.join(tmp, f"batch-{s['tenant']}.npz")
    spec = {"topology": psf, "trajectory": dcd,
            "defaults": {"select": "name CA", "batch_size": 32},
            "jobs": specs}
    path = os.path.join(tmp, "jobs.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mdanalysis_mpi_tpu_torch",
                           "batch", path], capture_output=True, text=True,
                          env=env, cwd=tmp, timeout=600)
    t_cli = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"batch exited {proc.returncode}: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    states = [r["state"] for r in doc["jobs"]]
    check(states == ["done"] * 3, f"batch job states {states}")
    check(doc["serving"]["admission_shed_serial"] == 0,
          "batch shed a job to serial")
    u = Universe(psf, dcd)
    errs = []
    for s, key in zip(specs, keys):
        cfg = AnalysisConfig(analysis=s["analysis"], topology=psf,
                             trajectory=dcd, select="name CA",
                             engine=s.get("engine", "auto"))
        run_kw = {"batch_size": 32}
        if "transfer_dtype" in s:
            run_kw["transfer_dtype"] = s["transfer_dtype"]
        want = np.asarray(build_analysis(cfg, universe=u).run(
            **run_kw).results.materialize()[key])
        got = np.load(s["output"])[key]
        errs.append(float(np.abs(got - want).max()))
    print(f"serve batch: python -m mdanalysis_mpi_tpu_torch batch "
          f"(aligned-rmsf fused int16, rmsd, rgyr on config 1's PSF/DCD): "
          f"process {t_cli:.2f} s, its batch wall {doc['wall_s']} s; npz "
          f"vs in-process max |d| {', '.join(f'{e:.3g}' for e in errs)} A "
          f"(limit {SERVE_TOL}) on {card}")
    check(max(errs) <= SERVE_TOL, f"batch results {errs} A from the "
          "in-process runs")


def phase_serve(card, u, uw, ow):
    """Phase 15: the serving tier on the card → (fused launches,
    pair-histogram launches) of its main path."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fused, ph, rmsf_a = serve_tenants(card, u, ow, tmp)
        fused += serve_breaker(card, u, rmsf_a)
        serve_batch_cli(card, tmp)
    print(f"serve phase: {time.perf_counter() - t_phase:.1f} s, fused "
          f"launches {fused}, pair-histogram launches {ph} on {card}")
    return fused, ph


# ---------------------------------------------------------------- phase 16

#: the fleet's hosts and the device they serve on
FLEET_HOSTS = 2
FLEET_DEVICE = "cuda"
#: each host's DeviceBlockCache
FLEET_CACHE_MB = 8192
#: the chaos knob's hold of every received job on a host: the kill lands
#: while the victim still holds its first job
FLEET_RUN_DELAY = "0.5"
FLEET_TOL = 1e-5
#: the command line's hosts get no --device (the default, the card)
FLEET_CLI_ARGS = ()


def fleet_files(u, uw, tmp):
    """Phase 16's inputs in ``tmp``: the heavy atoms of phase 4's frames
    as a PSF and an int16 block store of 512-frame chunks, and phase 5's
    box as a PSF and a float32 DCD → dict of paths and the heavy
    universe's frames."""
    from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd
    from mdanalysis_mpi_tpu_torch.io.psf import write_psf
    from mdanalysis_mpi_tpu_torch.io.store import ingest

    t0 = time.perf_counter()
    idx = u.select_atoms("heavy").indices
    n_frames = u.trajectory.n_frames
    frames, _ = u.trajectory.read_block(0, n_frames, sel=idx)
    hu = heavy_universe(frames)
    paths = {"psf": os.path.join(tmp, "heavy.psf"),
             "store": os.path.join(tmp, "heavy.store"),
             "wpsf": os.path.join(tmp, "water.psf"),
             "wdcd": os.path.join(tmp, "water.dcd")}
    write_psf(paths["psf"], hu.topology)
    summary = ingest(hu.trajectory, paths["store"], chunk_frames=E2E_BATCH,
                     quant="int16")
    check(summary["n_chunks"] == -(-n_frames // E2E_BATCH)
          and summary["scale_overflow_chunks"] == 0,
          f"fleet store: {summary['n_chunks']} chunks, "
          f"{summary['scale_overflow_chunks']} overflowing the scale")
    write_psf(paths["wpsf"], uw.topology)
    nw = uw.trajectory.n_frames
    wframes, wdims = uw.trajectory.read_block(0, nw)
    write_dcd(paths["wdcd"], wframes, dimensions=wdims)
    print(f"fleet inputs: heavy PSF ({len(idx)} atoms) and int16 store "
          f"({n_frames} frames, {summary['n_chunks']} chunks of "
          f"{E2E_BATCH}, {summary['bytes']} bytes, ingest {summary['wall_s']}"
          f" s); water PSF + DCD ({uw.atoms.n_atoms} atoms x {nw} frames, "
          f"{os.path.getsize(paths['wdcd'])} bytes); "
          f"{time.perf_counter() - t0:.1f} s")
    return paths


def host_series(ctrl, name):
    """``{host: sum of the counter}`` from the hosts' federated
    snapshots."""
    return {hid: sum(m.get(name, {"values": {}})["values"].values())
            for hid, m in ctrl.host_metrics().items()}


def gpu_apps(pids, label):
    """Prints the card's compute apps of ``pids`` (nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"fleet nvidia-smi ({label}): {type(exc).__name__}: {exc}")
        return
    rows = [ln.strip() for ln in out.splitlines() if ln.strip()]
    mine = [r for r in rows if r.split(",")[0].strip() in
            {str(p) for p in pids}]
    print(f"fleet nvidia-smi compute apps ({label}; host pids "
          f"{sorted(pids)}): {mine or rows}")


def fleet_wave(card, paths, tmp):
    """Phase 16 (a) and (b): a two-host fleet on the card serves four
    jobs while one host is ``kill -9``'d, then a two-member InterRDF
    ensemble → (the hosts' fused launches in (a), the served results)."""
    from mdanalysis_mpi_tpu_torch.service.fleet import (DONE,
                                                        FleetController)
    from mdanalysis_mpi_tpu_torch.service.journal import replay_fleet

    common = {"topology": paths["psf"], "trajectory": paths["store"],
              "select": "heavy", "batch_size": E2E_BATCH}
    fused = {**common, "analysis": "aligned-rmsf", "engine": "fused",
             "transfer_dtype": "int16"}
    rdf = {"analysis": "rdf", "topology": paths["wpsf"],
           "trajectory": paths["wdcd"], "select": "name OW", "nbins": 75,
           "r_max": 15.0, "batch_size": RDF_BATCH, "engine": "pallas"}
    specs = {"A": {**fused, "tenant": "A"}, "B": {**fused, "tenant": "B"},
             "C": {**common, "analysis": "rmsd", "shards": 2,
                   "tenant": "C"},
             "D": {**rdf, "tenant": "D"}}
    workdir = os.path.join(tmp, "fleet")
    env = {"MDTPU_FLEET_RUN_DELAY": FLEET_RUN_DELAY}
    out = {}
    with FleetController(workdir, host_ttl_s=10.0, trace=True,
                         device=FLEET_DEVICE) as ctrl:
        done_calls = {}
        apply_done = ctrl._apply_done

        def counting_apply(hid, msg):
            done_calls[msg.get("fp")] = done_calls.get(msg.get("fp"), 0) + 1
            return apply_done(hid, msg)

        ctrl._apply_done = counting_apply
        t0 = time.perf_counter()
        procs = [ctrl.spawn_host(hb_interval_s=0.1, env=env,
                                 cache_mb=FLEET_CACHE_MB)
                 for _ in range(FLEET_HOSTS)]
        joined = {}
        while len(joined) < FLEET_HOSTS and time.perf_counter() - t0 < 120:
            with ctrl._lock:
                for hid in ctrl._hosts:
                    joined.setdefault(hid, time.perf_counter() - t0)
            time.sleep(0.02)
        check(len(joined) == FLEET_HOSTS,
              f"fleet hosts joined: {sorted(joined)} of {FLEET_HOSTS}")
        print("fleet hosts spawn-to-join: " + ", ".join(
            f"{h} {s:.2f} s" for h, s in sorted(joined.items()))
              + f" (pids {[p.pid for p in procs]}) on {card}")
        t_wave = time.perf_counter()
        jobs = {k: ctrl.submit(dict(s)) for k, s in specs.items()}
        # kill the host whose "job received" instant came back first:
        # it holds that job inside its run delay
        victim = None
        deadline = time.perf_counter() + 30
        while victim is None and time.perf_counter() < deadline:
            for hid, evs in ctrl.host_trace_events().items():
                if any(ev.get("name") == "fleet_job_received"
                       for ev in evs):
                    victim = hid
                    break
            time.sleep(0.02)
        check(victim is not None, "no host reported a received job")
        gpu_apps(ctrl._host_pids.values(), "before the kill")
        check(ctrl.kill_host(victim), f"could not kill {victim}")
        t_kill = time.perf_counter() - t_wave
        drained = ctrl.drain(timeout=600)
        wall = time.perf_counter() - t_wave
        check(drained, "phase 16's fleet did not drain in 600 s")
        survivor = next(h for h in joined if h != victim)
        gpu_apps([ctrl._host_pids[survivor]], "after the drain")
        states = {k: j.state for k, j in jobs.items()}
        check(all(s == DONE for s in states.values()),
              f"fleet jobs {states}: "
              f"{ {k: j.error for k, j in jobs.items() if j.error} }")
        stats = ctrl.stats()
        n_fused = {h: 0 for h in joined}
        leaves = [c for j in jobs.values() for c in (j.children or [j])]
        for j in (jobs["A"], jobs["B"]):
            n_fused[j.host] += 1
        # the hosts' counters ship on heartbeats, after the completions
        want = {h: 8 * n for h, n in n_fused.items()}
        deadline = time.perf_counter() + 20
        while time.perf_counter() < deadline:
            blocks = host_series(ctrl, "mdtpu_fused_blocks_total")
            if all(blocks.get(h, 0) >= w for h, w in want.items()):
                break
            time.sleep(0.05)
        blocks = host_series(ctrl, "mdtpu_fused_blocks_total")
        shed = host_series(ctrl, "mdtpu_admission_shed_serial_total")
        reroutes = host_series(ctrl, "mdtpu_breaker_reroutes_total")
        # the migrated job's trace id on two pids
        migrated = [c.fp for c in leaves if c.migrations > 0]
        stitched = None
        deadline = time.perf_counter() + 10
        while migrated and stitched is None and \
                time.perf_counter() < deadline:
            per_fp = {}
            for hid, evs in ctrl.host_trace_events().items():
                for ev in evs:
                    args = ev.get("args") or {}
                    for fp in migrated:
                        if (args.get("trace_id") == fp
                                or fp in (args.get("trace_ids") or ())):
                            per_fp.setdefault(fp, set()).add(ev.get("pid"))
            stitched = next((fp for fp, p in per_fp.items()
                             if len(p) >= 2), None)
            if stitched is None:
                time.sleep(0.1)
        trace_path = ctrl.export_fleet_trace(os.path.join(tmp, "fleet.json"))
        with open(trace_path) as f:
            pids = {ev["pid"] for ev in json.load(f)["traceEvents"]
                    if ev.get("ph") != "M"}
        results = {k: j.result_arrays() for k, j in jobs.items()}
        print(f"fleet wave: {len(jobs)} jobs ({len(leaves)} host jobs) on "
              f"{FLEET_HOSTS} hosts, {victim} kill -9'd "
              f"{t_kill:.2f} s into the wave, drained in {wall:.2f} s on "
              f"{card}")
        for k, j in jobs.items():
            for c in (j.children or [j]):
                resends = done_calls.get(c.fp, 0) - 1
                print(f"fleet job {k} {c.fp}: host {c.host}, latency "
                      f"{c.latency_s:.3f} s, migrations {c.migrations}, "
                      f"completion resends before the ack {resends}")
        print(f"fleet per-host federated mdtpu_fused_blocks_total {blocks} "
              f"(AlignedRMSF jobs finished {n_fused}); serial sheds "
              f"{shed}, breaker reroutes {reroutes}; stats hosts_lost "
              f"{stats['hosts_lost']}, jobs_migrated "
              f"{stats['jobs_migrated']}; trace pids {len(pids)}, "
              f"stitched {stitched}")
        check(stats["hosts_lost"] == 1 and stats["jobs_migrated"] >= 1,
              f"hosts_lost {stats['hosts_lost']}, jobs_migrated "
              f"{stats['jobs_migrated']}")
        check(all(blocks.get(h, 0) >= w for h, w in want.items()),
              f"federated fused blocks {blocks} below 8 a finished "
              f"AlignedRMSF job ({want})")
        check(not any(shed.values()) and not any(reroutes.values()),
              f"a fleet job left the card: serial sheds {shed}, "
              f"reroutes {reroutes}")
        check(len(pids) >= 2 and stitched is not None,
              f"merged trace: {len(pids)} pids, stitched trace id "
              f"{stitched} of migrated {migrated}")
        # (b) the ensemble of two InterRDF windows, on the survivor
        t_ens = time.perf_counter()
        ens = ctrl.submit({**rdf, "tenant": "E",
                           "ensemble": [{"start": 0, "stop": 32},
                                        {"start": 32, "stop": 64}]})
        check(ctrl.drain(timeout=300) and ens.state == DONE,
              f"the InterRDF ensemble ended {ens.state}: {ens.error}")
        t_ens = time.perf_counter() - t_ens
        out["ensemble"] = ens.result_arrays()
        host_launches = sum(blocks.values())
    meta = replay_fleet(os.path.join(workdir, "fleet_journal.jsonl"))
    fps = [c.fp for c in leaves] + [c.fp for c in ens.children]
    once = {fp: meta["finishes"].get(fp) for fp in fps}
    check(all(n == 1 for n in once.values()),
          f"journal finishes per job {once}")
    dumps = [p for p in os.listdir(workdir)
             if p.startswith("flight_host_loss_")]
    check(dumps, "the lost host left no flight dump")
    print(f"fleet journal: exactly one finish for each of {len(fps)} host "
          f"jobs; flight dumps {dumps}; ensemble of 2 InterRDF members "
          f"{t_ens:.2f} s")
    out.update(results)
    return host_launches, out, wall


def fleet_encode(arrays):
    """The completion's JSON (the host's ``.tolist()`` of the result
    arrays) → (bytes, encode s, decode is float32-exact)."""
    t0 = time.perf_counter()
    line = (json.dumps({"ev": "done", "results": {
        k: np.asarray(v).tolist() for k, v in arrays.items()}}) + "\n")
    t_enc = time.perf_counter() - t0
    back = json.loads(line)["results"]
    exact = all(np.array_equal(np.asarray(back[k], np.float32),
                               np.asarray(v, np.float32))
                for k, v in arrays.items())
    return len(line.encode()), t_enc, exact


def fleet_solos(card, paths, got):
    """Phase 16's served results against in-process runs on the card."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import (AlignedRMSF, InterRDF,
                                                   RMSD)

    run_kw = dict(backend="torch", device=FLEET_DEVICE, batch_size=E2E_BATCH)
    t0 = time.perf_counter()
    solo = AlignedRMSF(Universe(paths["psf"], paths["store"]), select="heavy",
                       engine="fused").run(transfer_dtype="int16", **run_kw)
    want = solo.results.rmsf
    for k in ("A", "B"):
        g = got[k]["rmsf"]
        err = float(np.abs(g - want).max())
        print(f"fleet {k} vs the in-process AlignedRMSF(engine='fused') on "
              f"the store: max |d rmsf| {err:.3g} A (limit {FLEET_TOL}), "
              f"bit-equal {np.array_equal(g, want)}")
        check(err <= FLEET_TOL, f"served {k} RMSF {err:.3g} A from solo")
    nbytes, t_enc, exact = fleet_encode(got["A"])
    print(f"fleet completion of A: {nbytes} bytes of JSON "
          f"({sum(np.asarray(v).size for v in got['A'].values())} floats), "
          f"encoded in {t_enc:.3f} s here; float32 -> JSON -> float32 "
          f"exact {exact}")
    check(exact, "the completion's JSON does not round-trip float32")
    rmsd = RMSD(Universe(paths["psf"], paths["store"]), select="heavy").run(
        **run_kw).results.rmsd
    err = float(np.abs(got["C"]["rmsd"] - rmsd).max())
    print(f"fleet C (2 shards merged) vs the unsharded in-process RMSD: "
          f"max |d| {err:.3g} A (limit {FLEET_TOL}), bit-equal "
          f"{np.array_equal(got['C']['rmsd'], rmsd)}")
    check(got["C"]["rmsd"].shape == rmsd.shape and err <= FLEET_TOL,
          f"served C RMSD {err:.3g} A from the unsharded run")
    uw = Universe(paths["wpsf"], paths["wdcd"])
    ow = uw.select_atoms("name OW")
    rdf_kw = dict(backend="torch", device=FLEET_DEVICE, batch_size=RDF_BATCH)

    def kernel_rdf(**window):
        return InterRDF(ow, ow, nbins=75, range=(0.0, 15.0),
                        engine="pallas").run(**window, **rdf_kw).results

    r = kernel_rdf()
    e_r = rel_err(got["D"]["rdf"], r.rdf)
    same = np.array_equal(got["D"]["count"], r.count)
    print(f"fleet D vs the in-process InterRDF(engine='pallas'): counts "
          f"equal {same}, g(r) {e_r:.3g} relative (limit {FLEET_TOL})")
    check(same and e_r <= FLEET_TOL,
          f"served D: counts equal {same}, g(r) {e_r:.3g} relative")
    halves = [kernel_rdf(start=0, stop=32), kernel_rdf(start=32, stop=64)]
    ens = got["ensemble"]
    count = halves[0].count.astype(np.float64) + halves[1].count
    g = 0.5 * (np.asarray(halves[0].rdf, np.float64) + halves[1].rdf)
    same = np.array_equal(ens["count"], count)
    e_g = rel_err(ens["rdf"], g)
    print(f"fleet ensemble (2 InterRDF windows of 32 frames): merged count "
          f"equal to the sum of the in-process kernel runs' {same}, "
          f"frame-weighted g(r) {e_g:.3g} relative (limit {FLEET_TOL}); "
          f"in-process runs {time.perf_counter() - t0:.1f} s on {card}")
    check(same and e_g <= FLEET_TOL,
          f"ensemble: counts equal {same}, g(r) {e_g:.3g} relative")


def fleet_cli(card, tmp):
    """Phase 16 (c): ``python -m mdanalysis_mpi_tpu_torch fleet`` on
    config 1's PSF/DCD, no --backend and no --device → its hosts' fused
    blocks."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.utils.config import (AnalysisConfig,
                                                       build_analysis)

    psf, dcd, _ = write_config1(tmp)
    specs = [{"analysis": "aligned-rmsf", "engine": "fused",
              "transfer_dtype": "int16", "tenant": "a"},
             {"analysis": "rmsd", "tenant": "d"},
             {"analysis": "rgyr", "tenant": "g"}]
    keys = ("rmsf", "rmsd", "rgyr")
    for s in specs:
        s["output"] = os.path.join(tmp, f"fleet-{s['tenant']}.npz")
    path = os.path.join(tmp, "fleet-jobs.json")
    with open(path, "w") as f:
        json.dump({"topology": psf, "trajectory": dcd,
                   "defaults": {"select": "name CA", "batch_size": 32},
                   "jobs": specs}, f)
    metrics = os.path.join(tmp, "fleet-metrics.json")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mdanalysis_mpi_tpu_torch", "fleet", path,
         "--hosts", "2", "--metrics-out", metrics, *FLEET_CLI_ARGS],
        capture_output=True, text=True, env=env, cwd=tmp, timeout=600)
    t_cli = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"fleet exited {proc.returncode}: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    states = [r["state"] for r in doc["jobs"]]
    check(states == ["done"] * 3, f"fleet job states {states}")
    with open(metrics) as f:
        snap = json.load(f)

    def total(name):
        return sum(snap[name]["values"].values())

    blocks = total("mdtpu_fused_blocks_total")
    shed = total("mdtpu_admission_shed_serial_total")
    check(blocks >= 8 and shed == 0,
          f"the fleet command's hosts: {blocks} fused blocks (8 expected "
          f"of its AlignedRMSF), {shed} serial sheds")
    u = Universe(psf, dcd)
    errs = []
    for s, key in zip(specs, keys):
        cfg = AnalysisConfig(analysis=s["analysis"], topology=psf,
                             trajectory=dcd, select="name CA",
                             engine=s.get("engine", "auto"))
        run_kw = {"batch_size": 32, "device": FLEET_DEVICE}
        if "transfer_dtype" in s:
            run_kw["transfer_dtype"] = s["transfer_dtype"]
        want = np.asarray(build_analysis(cfg, universe=u).run(
            **run_kw).results.materialize()[key])
        got = np.load(s["output"])[key]
        errs.append(float(np.abs(got - want).max()))
    print(f"fleet command: python -m mdanalysis_mpi_tpu_torch fleet --hosts 2 "
          f"(aligned-rmsf fused int16, rmsd, rgyr on config 1's PSF/DCD, no "
          f"--backend, no --device): process {t_cli:.2f} s, its wall "
          f"{doc['wall_s']} s; hosts' fused blocks {blocks:g}, serial sheds "
          f"{shed:g}; npz vs in-process max |d| "
          f"{', '.join(f'{e:.3g}' for e in errs)} (limit {FLEET_TOL}) on "
          f"{card}")
    check(max(errs) <= FLEET_TOL, f"fleet command results {errs} from the "
          "in-process runs")


def phase_fleet(card, u, uw):
    """Phase 16: the fleet tier on the card → the fleet hosts' fused
    launches on its main path (the federated counter)."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    if FLEET_DEVICE != "cpu":
        # the hosts get the card's memory that earlier phases cached
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mdtpu_fleet_")
    try:
        paths = fleet_files(u, uw, tmp)
        launches, got, wall = fleet_wave(card, paths, tmp)
        fleet_solos(card, paths, got)
        fleet_cli(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"fleet phase: {time.perf_counter() - t_phase:.1f} s (wave "
          f"{wall:.1f} s), fused launches in the fleet hosts {launches} "
          f"(their federated mdtpu_fused_blocks_total) on {card}")
    return launches


#: phases that run on the water box built once for them
WATER_PHASES = {3, 5, 10, 12, 13, 14, 15, 16}
#: phases that launch each kernel on its main path (phase 16's fused
#: launches are its fleet hosts', read from their federated counter;
#: its hosts' pair-histogram launches have no counter that crosses
#: processes, so that kernel's count leaves them out)
FUSED_PHASES = (4, 8, 14, 15, 16, 9, 10)
PH_PHASES = (5, 15, 10)
#: phases that run on what another phase builds → that phase
NEEDS = {6: 4, 8: 4, 9: 4, 10: 4, 12: 4, 14: 4, 15: 4, 16: 4, 5: 3}
NEEDS_WHY = {4: "phase 4's system and its RMSF",
             3: "phase 3's main pair-histogram case"}


def select_phases(argv):
    """The phases to run: every phase with no argument, else those of
    ``--phases a,b,...`` and phases 1 and 2.  A selection that leaves
    out a phase another selected phase needs is refused (ValueError)."""
    if not argv:
        return set(PHASE_ORDER)
    if argv[0] != "--phases" or len(argv) != 2:
        raise ValueError(f"unknown arguments {argv}; the script takes no "
                         "argument or --phases N,N,...")
    try:
        chosen = {int(x) for x in argv[1].split(",") if x.strip()}
    except ValueError:
        raise ValueError(f"--phases {argv[1]!r}: a comma list of phase "
                         "numbers") from None
    bad = sorted(chosen - set(PHASE_ORDER))
    if bad:
        raise ValueError(f"--phases: no phase {bad}; the phases are "
                         f"{sorted(PHASE_ORDER)}")
    chosen |= {1, 2}
    for p in sorted(chosen):
        need = NEEDS.get(p)
        if need is not None and need not in chosen:
            raise ValueError(
                f"--phases: phase {p} runs on {NEEDS_WHY[need]}; select "
                f"phase {need} too")
    return chosen


def main_path_launches(name, count, kernel_phases, phases):
    """A kernel's launches on its whole main path: ``count`` when every
    phase of ``kernel_phases`` ran, else None (a count of some of the
    path is no count of it; that count is printed instead)."""
    ran = [p for p in kernel_phases if p in phases]
    if len(ran) == len(kernel_phases):
        return count
    print(f"{name} launches: {count} in phases {ran} of its main path's "
          f"{list(kernel_phases)}, so the kernel table's count is null")
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not os.path.isdir(os.path.join(HERE, "mdanalysis_mpi_tpu_torch")):
        print("FAIL: chip_smoke.py must run from a checkout of the "
              "repository (mdanalysis_mpi_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if argv[:1] == ["--rank"]:
        # a rank of phase 9's two-rank leg, started by phase 9 itself
        rank_child(int(argv[1]), int(argv[2]), argv[3], argv[4])
        return 0
    if argv[:1] == ["--warmup-probe"]:
        # a fresh process of phase 10's warmup leg, started by phase 10
        warmup_child(argv[1], argv[2], argv[3])
        return 0
    try:
        phases = select_phases(argv)
    except ValueError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 2
    if phases != set(PHASE_ORDER):
        print(f"phases: {sorted(phases)} of {list(PHASE_ORDER)} (in the "
              f"order {[p for p in PHASE_ORDER if p in phases]})")
    launches = ph_launches = 0
    fleet_launches = None
    rows = ph_rows = None
    try:
        card = phase_device()
        phase_build()
        card_name = card.split(",")[0].strip()
        u = ow = u_e2e = None
        if phases & WATER_PHASES:
            t0 = time.perf_counter()
            u, ow = make_water(RDF_WATERS, RDF_BOX, RDF_FRAMES)
            print(f"water system: {u.atoms.n_atoms} atoms x {RDF_FRAMES} "
                  f"frames, built in {time.perf_counter() - t0:.1f} s")
        if 3 in phases:
            rows, worst = phase_kernels(card_name)
            ph_rows, ph_worst = phase_pair_histogram(card_name, ow)
        if 4 in phases:
            launches, u_e2e, rmsf_e2e = phase_end_to_end(card)
        if 8 in phases:
            launches += phase_store(card, u_e2e)
        if 14 in phases:
            launches += phase_files(card, u_e2e, rmsf_e2e, u)
        if 5 in phases:
            ph_launches += phase_rdf(card, u, ow, ph_rows["main"])
        if 15 in phases:
            serve_fused, serve_ph = phase_serve(card, u_e2e, u, ow)
            launches += serve_fused
            ph_launches += serve_ph
        if 16 in phases:
            fleet_launches = phase_fleet(card, u_e2e, u)
            launches += fleet_launches
        if 6 in phases:
            phase_rmsd(card, u_e2e)
        if 9 in phases:
            multi_launches, t_multi = phase_multi(card, u_e2e, rmsf_e2e)
            launches += multi_launches
            print(f"multi-device phase: {t_multi:.1f} s, fused launches "
                  f"{multi_launches}")
        if 10 in phases:
            scan_launches, scan_ph = phase_scan(card, u_e2e, u, ow)
            launches += scan_launches
            ph_launches += scan_ph
        if 12 in phases:
            phase_analyses(card, u_e2e, u, ow)
        if 13 in phases:
            phase_remaining(card, u, ow)
        del u, ow, u_e2e
        if 7 in phases:
            phase_configs(card)
        if 11 in phases:
            phase_neighbours(card)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    import torch

    def entry(name, source, replaces, launches, worst, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    if fleet_launches is not None:
        print(f"{KERNEL_NAME} launches: {launches} on the main path, of "
              f"which {fleet_launches} in phase 16's fleet host processes "
              f"(their federated mdtpu_fused_blocks_total), "
              f"{launches - fleet_launches} in this process")

    if rows is None:
        print("kernel table: not printed (phase 3, which measures the "
              "kernels against their plain versions, was not selected)")
    else:
        fused_entry = entry(KERNEL_NAME, KERNEL_SOURCE, KERNEL_REPLACES,
                            main_path_launches(KERNEL_NAME, launches,
                                               FUSED_PHASES, phases),
                            worst, rows["main-int16"])
        # the part of ``launches`` made in other processes, so labelled
        fused_entry["fleet_host_launches"] = fleet_launches
        print(json.dumps({"kernels": [
            fused_entry,
            entry(PH_NAME, PH_SOURCE, PH_REPLACES,
                  main_path_launches(PH_NAME, ph_launches, PH_PHASES,
                                     phases),
                  ph_worst, ph_rows["main"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
