"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels [--tree DIR]
    python3 chip_smoke.py --table
    python3 chip_smoke.py --coupled
    python3 chip_smoke.py --options
    python3 chip_smoke.py --lateral
    python3 chip_smoke.py --stoch
    python3 chip_smoke.py --hybgen
    python3 chip_smoke.py --rk2b-oda
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --gate NAME

With ``--kernels`` only phases 1-3 run and the kernels' times are printed
as one JSON line; ``--tree DIR`` takes the port from another checkout
(say the parent commit, unpacked with ``git archive``), so that two
versions of a kernel are timed by one script on one card.  ``--table``
runs phases 1 and 2, the Thomas checks at wave_speed's (nz-1) shapes and
the diag_table part of phase 12 only.  ``--coupled`` runs phases 1
and 2, the Thomas and remap checks at the coupled cycle's shapes and
phase 16 only.  ``--options`` runs phases 1 and 2, the split Thomas
check and phase 17 only.  ``--lateral`` runs phases 1 and 2, the flux checks with
a per-layer face of phase 3 and phase 18 only.  ``--stoch`` runs phases
1 and 2 and phase 19 only.  ``--hybgen`` runs phases 1 and 2 and phases
20 and 21 only.  ``--rk2b-oda`` runs phases 1 and 2 and phases 22 and 23
only.  ``--mesh`` runs phases 1 and 2 and phase 24 only.  ``--gate NAME``
runs one physics gate of tests/torch_gates.py on the card and prints its
record and launch counts as one JSON line (phase 10 starts these).

Phases (each prints its own lines; any failure raises and exits non-zero),
run in the order 1-4, 6-8, the first half of 12, 13, 14, 15, 16, 17, 18,
the first part of 19, 20-24, then 5, 9, 11, the rest of 12 and of 19
while the
gates of phase 10 run in processes of their own (nothing timed runs
beside the gates):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels of mom6_tpu_torch/csrc with nvcc, one
   compiler per source, all started together; registers, spills and
   shared memory of the Thomas, the remap and the PPM edge kernels from
   ptxas (no spills allowed);
3. kernels: each kernel against its plain PyTorch version on the card, with
   the kernel's and the plain version's times and the card's bound for the
   same work: the Thomas solve and the PPM passes at the global path's
   (32, 400, 720), the thermo slice's (32, 280, 360), the double gyre's
   (8, 280, 360), at (75, 270, 360), at the shapes of the open-boundary
   run directories (OBC_KERNEL_SHAPES) and at those of phase 14's
   (RUNDIR_KERNEL_SHAPES: rows of 2 and 4 cells, adjustment's periodic
   in y, spherical_gyre's (10, 24, 30), tides_channel's (10, 12, 40),
   isomip's (12, 8, 32), tc1's, tc2's and nonbouss_basin's (8, 8, 10));
   the Thomas solve at the systems JHL's kappa_shear ((7, 8, 10), 18 a
   call, and its mixing of u, v, T and S) and PPM_IH4's compact edge
   values ((9, 8, 10), a unit diagonal) make on tc2's and
   nonbouss_basin's states, captured from the path, float64 and float32;
   the Thomas solve as the ADAPTIVE coordinate calls it on
   spherical_gyre's state, (9, 24, 30), and as wave_speed calls it for
   tides_channel's internal tides, (9, 12, 40); the Thomas solve as the
   vertical
   diffusion calls it (coefficients (32, 1, 400, 720) shared by the two
   right-hand sides of a transposed (2, 32, 400, 720) tensor and by the
   six of T, S and the NPZD tracers of phase 16, and
   (32, 1, 280, 360) by the three of T, S and the age, and the diabatic
   solve of T and S on tidal_bay (3, 1, 24, 48), dome (14, 1, 32, 48),
   spherical_gyre (10, 1, 24, 30) and tides_channel (10, 1, 12, 40)),
   and with coefficients of each tracer's own, (32, 2, 400, 720), as
   double diffusion's split T/S solve of phase 17 calls it;
   the ALE remap (also at the four's shapes) at
   (nf=6, 2 and 1, 32, 400, 720), (nf=3, 2 and 1, 32, 280, 360), (nf=3 and
   2, 75, 270, 360), dome's (nf=2 and 1, 14, 32, 48), spherical_gyre's
   and tides_channel's (nf=2 and 1, 10, 24, 30 and 10, 12, 40), from 32 to 40
   layers, with five fields, and onto the source grid itself (every
   interface ties); the quartic remap (NPOLY = 5) with the PQM_IH4IH3
   coefficients of the port's reconstruction at hycom_basin's (nf=2 and
   1, 12, 18, 20) onto its HYCOM1 targets and at (nf=2, 32, 400, 720);
   the y passes across the
   tripolar fold on the half-degree global grid at (32, 400, 720) and on a
   polar cap at (7, 33, 45).  Every kernel must equal its plain version
   to the bit; each kernel's own device time (torch.profiler) is
   reported beside its time from an idle device;
4. the fold, exactly: a bump on the north pole of a polar cap without
   rotation stays mirror-symmetric to the bit over 10 steps;
5. float64, on the card with the kernels against the CPU with the plain
   versions: the split-RK2 double gyre at 24x22x2 for 3 steps, thermo_gyre
   at 16x14x6 for 2 thermo cycles, one thermo cycle of a 32x24x5
   tripolar global model (configs/global_2deg's MOM_input on a generated
   mosaic, USE_KPP = False; KPP is in phases 8 and 9), 2 cycles of the
   cooled 100-level ePBL column of the convection gate, and 3 unsplit RK3
   steps of a 48x24 soliton; the kernel launches of one ePBL cycle;
6. the adiabatic path: the double gyre at 360x280x8 through
   drivers.solo.run_segment for 20 steps in float32, with the launch count
   of every kernel, the ms per baroclinic step and a phase breakdown;
7. the full-physics path, bench.py's headline case (thermo_gyre with GM
   and MEKE, KHTR, KPP, shear mixing and the ideal age): 360x280x32 at dt
   1200 s through run_segment for 10 thermo cycles (20 baroclinic steps),
   then the OM4 tile of bench.py, 360x270x75 at dt 900 s, for 3 cycles,
   both in float32: the launch count of every kernel, conservation of mass
   and salt, the heat budget, the age (finite, a trace in the top layer,
   positive below it, never older than the run) and KPP's boundary-layer
   depth, the ms per thermo cycle and SYPD, a profile of one cycle and (at
   360x280x32) a phase breakdown;
8. the global path: configs/global_half_deg/MOM_input as committed (KPP
   on) through drivers.config_driver.build_model_from_params (the 720x400
   mosaic generated in memory), one thermo cycle, then run_segment for 2
   more (18 baroclinic steps in all) at 720x400x32 in float32: finite
   fields, mass drift, wet temperatures in range, land columns untouched,
   KPP's viscosity kv_shear after the first cycle (finite, >= 0, zero at
   the surface and the bottom; how many columns it reaches), the
   boundary-layer depth finite and inside [min_hbl, column depth]; two
   cycles from a state where KPP mixes below the top layer (a mixed top
   under cooling: kv_shear there nonzero at full width; configs/
   global_2deg in float64, cycle by cycle, card against CPU); the launch
   count of every kernel with the fold launches apart, the ms per thermo
   cycle without and with stats, a profile of one cycle and a phase
   breakdown (KPP and shear mixing among the phases);
9. the golden configurations (configs/double_gyre, benchmark, rho_basin
   and global_2deg, the reference's golden tests) at their committed size
   and cycle count, each built by build_model_from_params in float64 on
   the card and on the CPU: each cycle run on the card from the CPU's
   state before it against the CPU's cycle (ocean.stats: mass, heat and
   salt to 1e-12 relative, KE and APE to 1e-9), and the two free runs
   to the same tolerances;
10. the physics gates: the twelve cases of tests/test_analytic_parity.py
   and tests/test_pf_pierced.py, ten of tests/test_user_configs.py
   (the Phillips jet balanced, scm_kpp mixing under wind, Neverworld's
   topography and stability, the hurricane's wind and its cold wake right
   of the track, supercritical stepping stably, the Kelvin wave trapped at
   the coast, the shelf wave trapped on the shelf, DOME's inflow entering
   and descending and its plume turning west after 2 days), the tidal bay
   pumped by its file data (tests/test_obc_file_reservoir.py), tc3's
   radiation against a closed twin (tests/test_tc_ladder.py) and Flather
   and Orlanski radiating waves out (tests/test_obc.py), and ten of the
   sponge, the BBL, LF17, the bulk mixed layer and HYCOM1 (dense_water
   stepping stably, tc4's sponge under z*, adjustment's front staying
   balanced, tests/test_coupler_waves.py's LF17 deepening, two of
   tests/test_bulk_ml.py, two of tests/test_regrid_hybrid.py and two of
   tests/test_wired_subsystems.py), and twenty-four of neutral diffusion,
   the ADAPTIVE coordinate, the internal tides, the tidal mixing, the
   tidal wave drag and the spherical gyre (test_neutral_diffusion.py,
   test_regrid_hybrid.py::test_adaptive_*, test_internal_tides.py,
   test_tidal_mixing.py, test_bt_cont.py, test_ensemble_spherical.py),
   and nine of the ice shelf, tc1, tc2 and the non-Boussinesq mode
   (test_shelf_coupling.py, test_tc_ladder.py::TestTC1 and TestTC2,
   test_nonbouss_mode.py, nonbouss_basin's 12 cycles among them),
   through the port
   in float32 at their own size and
   length with their own asserts (tests/torch_gates.py; the wave drag's
   in float64, where its effect is above the rounding), five processes
   at a time on the card (``--gate``: a process for each, those of
   torch_gates.BATCHED six to a process); one line per case
   with what it measured, the analytic value and the seconds;
11. configs/tracer_batch (24 tracers) in float64 on the card and on the
   CPU: 4 cycles, each on the card from the CPU's state before it against
   the CPU's cycle (every tracer, h, T and S within 1e-10 of max-abs),
   the reference test's asserts on the dyes and the stocks;
12. the port's command line as users run it, ``python -m
   mom6_tpu_torch.drivers.solo DIR --days D`` in a subprocess on a fresh
   copy of each run directory under chip_smoke_out/solo: first
   configs/global_half_deg as committed for half a day (6 thermo cycles,
   float32): one finite ocean.stats line with the mass drift under 1e-6
   relative and the salt and heat drift columns, every output file,
   MOM.res.nc with every registered field at full shape, the wall ms per
   cycle and SYPD of ocean.cputime, and the kernel launches the CLI
   counted, each equal to 6 global cycles' (the build launches none);
   its restart restored on the card gives its ocean.stats line
   again, and one stats call at 720x400x32 is timed on the card
   (compute_stats_device) and on the host (compute_stats).  Then, beside
   the gates: rho_basin and tracer_batch in float64, 2 + 2 cycles
   (--restart-in) equal to 4 straight ones to the bit, and tidal_bay
   (its tracer reservoirs carried; a stats line a cycle, so that both runs
   take the segment data at the same times) and tides_channel (its
   internal tides' En_itide carried); the nine run directories of
   the idealized user cases, the six with open boundaries (kelvin,
   shelfwave, supercritical, tidal_bay, dome, tc3) and the eight of phase
   14 (dense_water, tc4, adjustment, scm_lt, layered_bml, hycom_basin,
   spherical_gyre, tides_channel, isomip, tc1, tc2, nonbouss_basin) for
   2 cycles in
   float64 on the card and on the CPU (--device cpu), ocean.stats to
   1e-12 (mass, heat, salt) and 1e-9 (KE, APE), the restart fields to
   1e-10 of max-abs (hycom_basin, whose free runs amplify a last bit,
   one cycle at a time from the CPU's state: ``CYCLE_BY_CYCLE``);
   seasonal_gyre for half a day in float32
   through its forcing file, whose wind changes from segment to segment.
   The gates of tests/test_user_configs.py on those run directories are
   in phase 10.  The diag_table path, timed alone after the
   global_half_deg day: configs/global_half_deg with
   configs/global_2deg's diag_table for half a day (6 cycles and one post of
   121 fields at 720x400x32, float32) and configs/global_2deg as
   committed for half a day in float64 (12 cycles, one post), each through
   the CLI: ocean.cputime's wall ms per cycle, SYPD and ms per post, 120
   or more finite fields, the rejections, and the launches held exactly
   to the cycles' (``fold_cycle``) and the posts' (``table_post``,
   ``PER_TABLE_POST`` at 720x400x32); then one post in this process on
   the state the day ended with: its launches (PER_TABLE_POST) and the
   time of its parts.  Beside the gates the same global_2deg run goes on
   the CPU (``--device cpu``): the card's ocean_diags.nc, diag_rejected
   and ocean.stats against the CPU's, every field within 1e-10 of its
   max-abs (on layers and faces that hold water), the stats to the
   golden tolerances.  Phase 3 checks the Thomas kernel at wave_speed's
   (nz-1) shapes of both, (19, 100, 180) and (31, 400, 720), float32 and
   float64 bitwise against its plain version;
13. the open boundaries: each of the six run directories above as
   committed in float32 on the card in this process, 3 thermo cycles
   (``N_OBC_CYCLES``)
   with the provider's segment data, their launches held exactly to
   ``obc_cycle`` (tc3's with set_bt_cont's extra x and y edge launch a
   step, dome's with the diabatic solve and the z* remaps), the wall ms
   per cycle and, from the profiler, the device's idle share of a cycle;
14. the sponge, the BBL drag, REENTRANT_Y, LF17, the bulk mixed layer and
   hycom_basin's set: dense_water, tc4, adjustment, scm_lt, layered_bml
   and hycom_basin as committed, the same as phase 13 (``[rundir]``
   lines; layered_bml's cycles remap u and v and solve no column,
   hycom_basin's remaps are the quartic kernel's, counted apart as
   remap_npoly5), and spherical_gyre (JACKETT06, ADAPTIVE: one more
   Thomas solve a cycle; the Redi scheme's diffusivity joins the
   diabatic solve) and tides_channel (the tidal mixing, the internal
   tides: wave_speed's 10 more Thomas solves a cycle; the tidal wave
   drag's piston map in the barotropic solver), and isomip (the ice
   shelf, SIGMA_SHELF_ZSTAR), tc1 (the layered benchmark, VarMix), tc2
   and nonbouss_basin (JHL: kappa_shear's 21 Thomas solves a cycle;
   PPM_IH4: one a reconstructed field; frazil, geothermal heating; the
   non-Boussinesq pressure force);
15. ``[ops]``: neutral_diffusion on T, S and 2 passive tracers,
   build_adaptive_grid, wave_speed then step_internal_tides (8 angles)
   and tidal_mixing_kd, one call each on global_half_deg's built state
   at (32, 400, 720) in float32: the median ms of 10 calls, the device
   ms, the launches and the Thomas kernel's share;
16. ``[coupled]``: the coupled entry points.  configs/global_half_deg
   with a MOM_override of FRAZIL, DYNAMIC_SURFACE_PRESSURE, SURFBANDS
   waves (3 bands, LA_MISALIGNMENT), DO_BRINE_PLUME, PEN_SW_NBANDS = 2
   and USE_generic_tracer (the NPZD ecosystem) through
   drivers/nuopc.py::NUOPCCap, float32 at 720x400x32: advertise, realize
   with a restart alarm that rings once, 4 coupling intervals of the
   full import menu (3-band Sw_pstokes, the sea-ice fraction and brine
   over a polar band, nitrogen deposition and CO2, Sw_lamult in the
   last), then 2 intervals of drivers/coupled_cap.py::
   update_ocean_model with the ice's mass and rigidity over the band:
   every export finite, the mass drift under 1e-6, the NPZD nitrogen
   conserved apart from the deposition (1e-5 of the total), the dated
   restart written with every field of the state; the wall ms of each
   interval, its launches held exactly to ``fold_cycle(6)``, the
   device's idle share of a profiled interval, whose diabatic solve and
   cell fields' remap are captured, each float32 and
   float64 bitwise against its plain version (phase 3 times them at
   those shapes); then the lifecycle on the 12x10x4 directory of
   tests/test_torch_coupled.py in float64, the card against the CPU:
   every export and restart field within 1e-10 of max-abs; the cell
   fields' remap held on every column, land included;
17. ``[options]``: the step's shared options.  configs/global_half_deg
   with tests/torch_gates.py::OPTIONS_OVERRIDE (BT_LIN_DRAG, BT_CDRAG,
   GL90, KHTR_PASSIVITY_COEFF and KHTR_MAX, the boundary-layer
   diffusion, CVMix convection, double diffusion) through the CLI for
   2 cycles in float32 at 720x400x32: ocean.stats finite, mass drift
   under 1e-6 and salt drift under 1e-5, launches held exactly to
   ``fold_cycle(6)`` a cycle, the wall ms a cycle; from its restart one
   profiled cycle (the idle share) whose split T/S diabatic solve (a, b,
   c of their own, (32, 2, 400, 720)) is captured and held bitwise in
   float32 and float64 (phase 3 times it at SPLIT_TRIDIAG), one cycle
   with DIABATIC_FIRST and one with HOMOGENIZE_FORCINGS, each with its
   launches held; then tests/test_torch_options.py's 12x10x6 directory
   in float64, the card against the CPU one cycle at a time, within
   1e-10 of max-abs;
18. ``[lateral]``: the lateral options.  configs/global_half_deg with
   tests/torch_gates.py::LATERAL_OVERRIDE (MEKE's backscatter and
   friction source, Leith and QG Leith, the flow-aligned anisotropic
   viscosity, ZB2020, the interface filter, the porous barriers and
   ARAKAWA_LAMB_BLEND) through the CLI for LATERAL_CYCLES cycles in
   float32 at 720x400x32: ocean.stats finite, mass drift under 1e-6 and
   salt drift under 1e-5, launches held exactly to ``fold_cycle(6)`` a
   cycle, the wall ms a cycle; from its restart a cycle whose PPM fluxes
   with a per-layer face (the porous barriers' open fractions) are
   captured, x and y across the fold, and held bitwise in float32 and
   float64 (phase 3 times that instance at (32, 400, 720), x and y fold,
   and periodic in y at POROUS_WRAP_SHAPE), a timed cycle, a profiled one
   (the idle share) and one cycle with each of SADOURNY75_ENSTRO,
   ARAKAWA_HSU90 and ARAKAWA_LAMB81, each with its launches held; then
   tests/test_torch_lateral.py's 12x10x6 directory with the override
   (ANISOTROPIC_MODE 2) in float64, the card against the CPU one cycle
   at a time, within 1e-10 of max-abs;
19. ``[rng]``, ``[eos]``, ``[stoch]`` and ``[tides]``: the port's
   threefry on the card against the CPU (keys, words and uniforms to the
   bit, the normals within 4 ulps, three float64 AR(1) steps of a
   pattern within 1e-10); the density, the first and
   the forward-mode second derivatives of WRIGHT_FULL, UNESCO and
   ROQUET_RHO at (32, 400, 720), float32 timed on the card, float64 on
   the card against the CPU (every 10th row and column) within 1e-10 of
   max-abs (UNESCO's derivatives, differences of the density, 1e-8);
   configs/global_half_deg
   with tests/torch_gates.py::STOCH_OVERRIDE (WRIGHT_FULL with the
   Stanley correction, the scalar and the harmonic SAL, SPPT and SKEB)
   through the CLI for STOCH_CYCLES cycles in float32 at 720x400x32:
   mass drift under 1e-6, salt drift under 1e-5, launches held exactly
   to ``fold_cycle(6)``; from its restart a cycle whose diabatic Thomas
   solve, PPM fluxes (x, y across the fold) and remap are captured and
   held bitwise in float32 and float64, a timed and a profiled cycle,
   max |u|; beside the gates configs/neverworld with the tide of M2, S2,
   K1 and O1 and the harmonic SAL in float64 through the CLI, card
   against CPU (ocean.stats to 1e-12 and 1e-9, the restart to 1e-10),
   and 2 + 2 cycles on the card equal to 4 straight ones to the bit;
20. ``[hybgen]``: configs/global_half_deg with
   tests/torch_gates.py::HYBGEN_OVERRIDE (HYBGEN with 32 potential
   density targets and HYCOM's minimum z profile, PPM_H6, TS_CONFIG =
   from_Z from a climatology on World Ocean Atlas 2018's layout, 360x180
   and 102 levels, written first from a seed with the model's land, each
   cell as deep as its deepest model point) through the CLI for
   HYBGEN_CYCLES cycles in float32 at 720x400x32 (max |u| then and a
   cycle later under HYBGEN_MAX_U):
   mass drift under 1e-6, salt drift under 1e-5, launches exactly
   ``fold_cycle(6)`` a cycle plus the build's two z_init remaps; the
   from_Z build timed in this process with the fill's relaxation passes;
   from the CLI's restart a timed and a profiled cycle (the idle share);
   the remaps of z_init (102 levels to 32 layers), of HYBGEN's T/S and u
   after PPM_H6 and of T/S after P3M_H4 (the quartic instance, one cycle
   with its launches held and its heat and salt held to the PPM_H6
   cycle's) captured from the path, each held bitwise in
   float32 and float64 and timed against the plain version and the
   bound;
21. ``[ice_solo]``: ``python -m mom6_tpu_torch.drivers.ice_solo`` on the
   MISMIP+ ice domain's extent and spacing (80 x 640 cells of 1 km) for
   3 daily steps: ice.stats finite, the volume and area drift; a timed
   and a profiled step (kernels a step, the idle share); in float64 on
   that grid, the card against the CPU: one viscosity, one operator
   application and a solve cut to 1 x 3 iterations to 1e-10, the whole
   8 x 60 solve beside the CPU's one-ulp sensitivity, its CG residuals;
22. ``[rk2b]``: configs/global_half_deg with
   tests/torch_gates.py::RK2B_OVERRIDE (SPLIT_RK2B) through the CLI for
   RK2B_CYCLES cycles in float32 at 720x400x32: mass drift under 1e-6,
   salt drift under 1e-5, launches exactly ``rk2b_fold_cycle(6)`` a cycle
   (one more PPM edge and flux launch a step in x and across the fold
   than ``fold_cycle``), the restart holding du_av_inst/dv_av_inst; from
   it in this process a cycle whose PPM flux forms are an RK2 cycle's
   (its Newton flux captured and held bitwise), a timed and a profiled
   cycle, the RK2 cycle from the same state (mass drift, max |u| beside
   RK2B's, under RK2B_MAX_U: the reference's RK2b grows in the tripolar
   cap); the six spatial means and the truncation dossier
   of the final state on the card against the CPU (equal); the 32x24x5
   tripolar model with RK2b and BT_CONT in float64, the card against the
   CPU cycle by cycle within 1e-10 (beside the gates);
23. ``[oda]``: configs/global_half_deg as committed, ODA_NE members (a
   shared large-scale T bias and a spread of each member's own, from a
   seed) and a truth run: ODA_CYCLES analyses of ODA_OBS surface-T
   observations (eakf_update at (4, 9,216,000) timed), the ensemble
   mean's error at the observed points before and after, the increments
   zero on land, one forecast cycle of every member with its increments
   ramped over it (launches exactly ODA_NE x ``fold_cycle(6)``); one
   cycle with an external analysis on 75 levels of its own (launches
   ``fold_cycle(6)`` + 2 remaps), the increments' PLM remaps captured and
   held bitwise; eakf_update, oda_analysis and the increments on the
   small tripolar model card against CPU in float64 (beside the gates);
   HarmonicAnalysis
   of M2, K1, S2 and O1 and a filter bank on 96 hourly samples of the
   truth's SSH plus known tidal maps, the maps recovered, an
   accumulate's time, card against CPU;
24. ``[mesh]``: configs/global_half_deg (720x400x32, f32) with
   ``MESH_OVERRIDE`` (SAL_HARMONICS beside SAL_SCALAR_VALUE, DO_SPPT,
   DO_SKEB) for one thermo cycle on the ranks of parallel/mesh.py, the
   plain one-rank cycle with the same options: four gloo ranks on cuda:0
   (processes of their own) on the 2x2 mesh and two on the 1x2 mesh,
   BT_WIDE_HALO AUTO on the 2x2 mesh, and this process as one NCCL
   rank: each cycle's gathered h, u, v, T, S and ocean.stats equal the
   plain one-rank cycle's to the bit; wall ms a cycle, exchanges and
   bytes a cycle, launches a rank and what the card did for 1, 2 and 4
   ranks (NVML's sampled utilization.gpu in a whole run; with
   ``--mesh`` the profiler's device ms of every rank and the card's
   idle share of the profiled cycle), the wide halo's exchanges against
   the dense path's; the kernels' tile forms captured from the 2x2
   cycle (the x edges and both fluxes on halo-padded tiles, the y edges'
   HALO form with and without the fold image row, the Thomas solve and
   the remap at their tile shapes) against their plain versions, 0
   ulps, timed with their bounds (and their device ms with ``--mesh``);
   the ensemble of four double-gyre members, one a rank, equal to
   ensemble_step in one process; the 2x2 cycle's restart written on the
   ranks (gathered to rank 0) and restored on one rank, every field
   equal to the one-rank cycle's; dome and isomip (``MESH_SMALL``) as
   committed for one cycle on the 1x2 mesh equal to one rank, their tile
   forms captured and held at 0 ulps, timed with their bounds;
25. a JSON line of the kernels (each with its row at every shape it was
   checked at), then the result line.

Long output (the ptxas report, the profiler tables) goes to
chip_smoke_out/ beside this script.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# the checkout whose port is driven: this one, or --tree DIR
TREE = (os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
        if "--tree" in sys.argv else REPO)
sys.path.insert(0, TREE)
# tests/torch_gates.py: the physics gates through the port (no jax)
sys.path.insert(1, os.path.join(TREE, "tests"))

from mom6_tpu_torch.ale import remapping as remap  # noqa: E402
from mom6_tpu_torch.ale.ale import ale_regrid_remap  # noqa: E402
from mom6_tpu_torch.ale.regridding import build_hycom1_grid  # noqa: E402
from mom6_tpu_torch.core import continuity_ppm as cppm  # noqa: E402
from mom6_tpu_torch.core.barotropic import btstep  # noqa: E402
from mom6_tpu_torch.core.continuity_ppm import continuity_ppm  # noqa: E402
from mom6_tpu_torch.core.coriolis_adv import coriolis_adv  # noqa: E402
from mom6_tpu_torch.core.dynamics_split_rk2 import (  # noqa: E402
    MechForcing, _visc_setup, step_dynamics_split_rk2)
from mom6_tpu_torch.core.mom import step_mom  # noqa: E402
from mom6_tpu_torch.core.pressure_force import (  # noqa: E402
    find_eta, pressure_force_fv, pressure_force_montgomery)
from mom6_tpu_torch.diagnostics.sum_output import compute_stats  # noqa: E402
from mom6_tpu_torch.diagnostics.wave_speed import wave_speed  # noqa: E402
from mom6_tpu_torch.drivers.config_driver import \
    build_model_from_params  # noqa: E402
from mom6_tpu_torch.drivers.experiments import (  # noqa: E402
    double_gyre, polar_cap_bump, thermo_gyre)
from mom6_tpu_torch.drivers.solo import (  # noqa: E402
    kernel_launches, make_mom_stepper, make_stepper, reset_kernel_launches,
    run_segment)
from mom6_tpu_torch.eos import get_eos  # noqa: E402
from mom6_tpu_torch.framework import kernels  # noqa: E402
from mom6_tpu_torch.framework import solvers  # noqa: E402
from mom6_tpu_torch.framework.config import ParamFile  # noqa: E402
from mom6_tpu_torch.framework.stencil import ip1, jp1  # noqa: E402
from mom6_tpu_torch.grid.grid import build_cartesian_grid  # noqa: E402
from mom6_tpu_torch.grid.tripolar import write_mosaic  # noqa: E402
from mom6_tpu_torch.physics.lateral.hor_visc import \
    horizontal_viscosity  # noqa: E402
from mom6_tpu_torch.physics.lateral.thickness_diffuse import \
    thickness_diffuse  # noqa: E402
from mom6_tpu_torch.physics.vertical.diabatic import diabatic_ale  # noqa: E402
from mom6_tpu_torch.physics.vertical.vert_friction import vertvisc  # noqa: E402
from mom6_tpu_torch.tracers.advect import advect_tracers  # noqa: E402
from mom6_tpu_torch.tracers.hor_diff import tracer_hordiff  # noqa: E402

OUT = os.path.join(REPO, "chip_smoke_out")
SLICE = dict(nx=360, ny=280, nz=8, len_lon_km=4500.0, len_lat_km=3500.0,
             dt=1200.0)
N_STEPS, STATS_INTERVAL = 20, 10
# bench.py's full-physics case (_full_physics_setup) at its headline size
# and at the OM4 tile of bench_om4_shape: (nx, ny, nz, dt, cycles, cycles
# between stats lines)
FULL_PHYSICS = {"full_physics": (360, 280, 32, 1200.0, 10, 5),
                "om4_tile": (360, 270, 75, 900.0, 3, 3)}
N_TRACER_CYCLES = 4
# physics gates run at once, a process each: the longest gate (Phillips,
# ~300-400 s on the card) bounds the pool, the others fill four more
N_GATE_PROCS = 5
# gates that the pool runs with CPU tensors: the twin experiment steps 16
# members and a control through 2112 cycles of a 24x20x3 model, each
# launch-bound on the card (285 s alone, 433 s in the pool of six; the
# same gate takes ~150 s of one host core with CPU tensors); the card
# runs the same ensemble and analysis code at 720x400x32 in [oda]
HOST_GATES = ("twin_experiment_reduces_error",)
GLOBAL_DIR = os.path.join(REPO, "configs", "global_half_deg")
GLOBAL_SHAPE = (32, 400, 720)
N_GLOBAL_CYCLES = 3
# simulated days of configs/global_half_deg through the CLI, alone and with
# global_2deg's diag_table (half a day: 6 thermo cycles and, with
# ENERGYSAVEDAYS = 1, one ocean.stats line and one post)
GLOBAL_CLI_DAYS = 0.5
# simulated days of configs/global_2deg in float64 through the CLI with its
# diag_table, on the card and on the CPU (half a day: 12 thermo cycles, one
# post; a day until the RK2b and ODA phases joined the script's 1200 s)
TABLE_2DEG_DAYS = 0.5
# the configurations of the reference's golden tests and their cycles
GOLDEN = {"double_gyre": 6, "benchmark": 4, "rho_basin": 4,
          "global_2deg": 3}
GOLDEN_TOL = {"mass": 1e-12, "heat": 1e-12, "salt": 1e-12, "KE": 1e-9,
              "APE": 1e-9}
# the small tripolar global model of the float64 check
SMALL_GLOBAL = ("NIGLOBAL = 32\nNJGLOBAL = 24\nNK = 5\nUSE_KPP = False\n"
                "TRACER_ADVECT_SUB = 3\n")
# kernel check shapes: the global path's and the thermo path's (both
# reported in the JSON line), the double gyre's, and a deep (OM4-like)
# column
KERNEL_SHAPES = (GLOBAL_SHAPE, (32, 280, 360), (8, 280, 360), (75, 270, 360))
# the (nz, ny, nx) of the open-boundary run directories: kelvin and
# shelfwave, supercritical, tidal_bay, dome, tc3 (one layer where nz = 1)
OBC_KERNEL_SHAPES = ((1, 32, 64), (1, 20, 60), (3, 24, 48), (14, 32, 48),
                     (10, 8, 10))
# the (nz, ny, nx) of the run directories of the sponge, the BBL drag,
# REENTRANT_Y, LF17, the bulk mixed layer and HYCOM1: dense_water, tc4,
# adjustment (periodic in y), scm_lt, layered_bml, hycom_basin; and of
# spherical_gyre and tides_channel
RUNDIR_KERNEL_SHAPES = ((12, 64, 4), (2, 10, 14), (10, 8, 64), (40, 2, 2),
                        (12, 20, 24), (12, 18, 20), (10, 24, 30),
                        (10, 12, 40), (12, 8, 32), (8, 8, 10))
REENTRANT_Y_SHAPES = ((10, 8, 64),)
# (nf, nz0, ny, nx) of the remap at npoly 5 (PQM_IH4IH3): T and S, then
# T, on hycom_basin with its HYCOM1 targets; T and S at full width
PQM_REMAP_SHAPES = ((2, 12, 18, 20), (1, 12, 18, 20), (2, 32, 400, 720))
# (nf, nz0, ny, nx) of the remap: T and S, then u or v, on the global and
# the thermo path; T and S of a deep column; those of the run
# directories; T, S and the NPZD tracers of the coupled global_half_deg
# (phase 16's capture)
REMAP_SHAPES = ((2, 32, 400, 720), (1, 32, 400, 720), (2, 32, 280, 360),
                (1, 32, 280, 360), (2, 75, 270, 360), (3, 32, 280, 360),
                (3, 75, 270, 360), (2, 14, 32, 48), (1, 14, 32, 48),
                (2, 10, 24, 30), (1, 10, 24, 30), (2, 10, 12, 40),
                (1, 10, 12, 40), (2, 12, 8, 32), (1, 12, 8, 32),
                (3, 8, 8, 10), (2, 8, 8, 10), (1, 8, 8, 10),
                (6, 32, 400, 720))
# more forms of the remap, (nf, nz0, ny, nx) and how the target grid is
# made: more target layers than source layers, five fields (two passes of
# the kernel), and a target grid equal to the source grid
REMAP_FORMS = (((2, 32, 400, 720), dict(nz1=40)),
               ((5, 32, 280, 360), {}),
               ((2, 32, 400, 720), dict(ties=True)))
# the Thomas solve as tracers/vert_diff.py calls it: (n_tr, nz, ny, nx) of
# T and S on the global path, of T, S and the age on the full-physics path,
# of T and S on tidal_bay and dome, spherical_gyre and tides_channel, of
# isomip, tc1, tc2 and nonbouss_basin, and of T, S and the NPZD tracers on
# the coupled global_half_deg (phase 16's capture)
SHARED_TRIDIAG = ((2,) + GLOBAL_SHAPE, (3, 32, 280, 360), (2, 3, 24, 48),
                  (2, 14, 32, 48), (2, 10, 24, 30), (2, 10, 12, 40),
                  (2, 12, 8, 32), (3, 8, 8, 10), (2, 8, 8, 10),
                  (4, 8, 8, 10), (6,) + GLOBAL_SHAPE)
# the Thomas solve of tracers/vert_diff.py with per-tracer diffusivities
# (double diffusion): T and S of the global path, (n_tr, nz, ny, nx), each
# column with a, b, c of its own ([options]' capture)
SPLIT_TRIDIAG = ((2,) + GLOBAL_SHAPE,)
# the PPM flux with a per-layer face, periodic in y (phase 3; x and the
# fold at GLOBAL_SHAPE on the half-degree grid)
POROUS_WRAP_SHAPE = (10, 8, 64)
# the shape whose numbers a kernel's row of the JSON line carries: that
# of the path that launches it
ROW_SHAPE = {"ppm_edges_y": (32, 280, 360), "ppm_flux_y": (32, 280, 360)}
# ... and the path whose launch count it carries
ROW_PATH = {"ppm_edges_y": "full_physics", "ppm_flux_y": "full_physics",
            "remap_npoly5": "rundir_hycom_basin",
            "ppm_edges_y_halo": "mesh"}
FOLD_CAP = dict(nx=45, ny_reg=20, ny_cap=13)       # an odd nx; (7, 33, 45)
# launches per baroclinic step of the double gyre and per thermo cycle of
# the full-physics case, the OM4 tile and tracer_batch (2 baroclinic
# steps, then 1 column solve of T, S and the passive tracers and 3 remaps:
# the cell fields, u, v)
PER_STEP = {"tridiag": 6, "ppm_edges_x": 3, "ppm_edges_y": 3,
            "ppm_flux_x": 9, "ppm_flux_y": 9, "ppm_edges_y_fold": 0,
            "ppm_flux_y_fold": 0, "remap": 0, "remap_npoly5": 0,
            "ppm_edges_y_halo": 0}
PER_CYCLE = {"tridiag": 13, "ppm_edges_x": 6, "ppm_edges_y": 6,
             "ppm_flux_x": 18, "ppm_flux_y": 18, "ppm_edges_y_fold": 0,
             "ppm_flux_y_fold": 0, "remap": 3, "remap_npoly5": 0,
             "ppm_edges_y_halo": 0}
# one baroclinic step of a tripolar configuration (its y passes cross the
# fold), and what a thermo cycle adds: the diabatic column solve and the
# remaps of the cell fields, u and v
PER_FOLD_STEP = {"tridiag": 6, "ppm_edges_x": 3, "ppm_edges_y": 0,
                 "ppm_flux_x": 9, "ppm_flux_y": 0, "ppm_edges_y_fold": 3,
                 "ppm_flux_y_fold": 9, "remap": 0, "remap_npoly5": 0,
                 "ppm_edges_y_halo": 0}
PER_THERMO = {"tridiag": 1, "remap": 3}


def fold_cycle(n_dyn):
    """Launches of one thermo cycle of a tripolar configuration with
    ``n_dyn`` baroclinic steps."""
    return {k: n_dyn * c + PER_THERMO.get(k, 0)
            for k, c in PER_FOLD_STEP.items()}


# one RK2b step of a tripolar configuration (SPLIT_RK2B,
# core/dynamics_split_rk2.py::step_dynamics_split_rk2b): four continuity
# calls where RK2 has three, two of them matched to the barotropic
# transports as in RK2 (each an edge launch a direction and 1 + _N_NEWTON
# flux launches) and two without (the time-filtered and the instantaneous
# velocities' transports: each an edge and a flux launch a direction), so
# one more edge and one more flux launch in x and across the fold; the
# same two remnants and four viscous solves
PER_RK2B_FOLD_STEP = dict(
    PER_FOLD_STEP, ppm_edges_x=PER_FOLD_STEP["ppm_edges_x"] + 1,
    ppm_flux_x=PER_FOLD_STEP["ppm_flux_x"] + 1,
    ppm_edges_y_fold=PER_FOLD_STEP["ppm_edges_y_fold"] + 1,
    ppm_flux_y_fold=PER_FOLD_STEP["ppm_flux_y_fold"] + 1)


def rk2b_fold_cycle(n_dyn):
    """Launches of one thermo cycle of a tripolar configuration with
    ``n_dyn`` RK2b steps."""
    return {k: n_dyn * c + PER_THERMO.get(k, 0)
            for k, c in PER_RK2B_FOLD_STEP.items()}


# the _z fields of configs/global_2deg/diag_table, each remapped once a
# post by the diag mediator
TABLE_Z_FIELDS = 12


def table_post(n_dyn):
    """Launches of one post of configs/global_2deg/diag_table on a
    tripolar configuration: the KE budget's split step, the tendency
    capture's thermo cycle, wave_speed's 10 Thomas solves at (nz-1) and
    one remap per _z field."""
    c = fold_cycle(n_dyn)
    extra = {"tridiag": 10, "remap": TABLE_Z_FIELDS}
    return {k: c[k] + PER_FOLD_STEP[k] + extra.get(k, 0) for k in c}


def obc_cycle(n_dyn, bt_cont=False, thermo=None, n_fields=2):
    """Launches of one thermo cycle of a configuration without the fold:
    ``n_dyn`` split steps, each with BT_cont one more x and y edge
    reconstruction (set_bt_cont); with ``thermo`` "layer" the diabatic
    column solve, "ale" that and the remaps of the cell fields, u and v
    (z*, RHO, HYCOM1), "ale_pqm" the same with the quartic remap
    (PQM_IH4IH3, counted as remap and as remap_npoly5), "ale_adaptive"
    the same as "ale" and the ADAPTIVE coordinate's smoothing solve,
    "ale_itides" the same as "ale" and the mode speed of the internal
    tides (wave_speed's n_iter solves; the Redi scheme's and the tidal
    mixing's diffusivities join the diabatic solve), "ale_jhl",
    "ale_ih4" and "ale_jhl_ih4" the same as "ale" and JHL's kappa_shear
    (kappa_shear_solves) and PPM_IH4's edge system of each reconstructed
    field (the ``n_fields`` cell fields, u and v), "bulkml" the layered
    sequence's remaps of u and v and no column solve."""
    per = dict(PER_STEP)
    if bt_cont:
        per["ppm_edges_x"] += 1
        per["ppm_edges_y"] += 1
    out = {k: n_dyn * c for k, c in per.items()}
    ale = ("ale", "ale_pqm", "ale_adaptive", "ale_itides", "ale_jhl",
           "ale_ih4", "ale_jhl_ih4")
    if thermo == "layer" or thermo in ale:
        out["tridiag"] += PER_THERMO["tridiag"]
    if thermo in ale:
        out["remap"] += PER_THERMO["remap"]
    if thermo == "ale_adaptive":
        out["tridiag"] += 1
    if thermo == "ale_itides":
        out["tridiag"] += WAVE_SPEED_SOLVES
    if thermo in ("ale_jhl", "ale_jhl_ih4"):
        out["tridiag"] += kappa_shear_solves()
    if thermo in ("ale_ih4", "ale_jhl_ih4"):
        out["tridiag"] += n_fields + 2
    if thermo == "ale_pqm":
        out["remap_npoly5"] += PER_THERMO["remap"]
    if thermo == "bulkml":
        out["remap"] += 2
    return out


# the run directories with open boundaries: (baroclinic steps a thermo
# cycle, BT_cont, thermodynamics) of their MOM_input
OBC_CONFIGS = {"kelvin": (1, False, None), "shelfwave": (1, False, None),
               "supercritical": (1, False, None),
               "tidal_bay": (2, False, "layer"), "dome": (2, False, "ale"),
               "tc3": (1, True, None)}
# thermo cycles of each in float32 on the card, timed and counted (10
# until the four run directories of isomip, tc1, tc2 and nonbouss_basin
# joined the path, then 5 until `[mesh]` took the options and dome and
# isomip on ranks: 3 keep the whole script inside its time limit)
N_OBC_CYCLES = 3
# the run directories of the sponge, the BBL drag, REENTRANT_Y, LF17, the
# bulk mixed layer and hycom_basin's set, and of JACKETT06, ADAPTIVE and
# neutral diffusion (spherical_gyre) and of the tidal mixing, the internal
# tides and the tidal wave drag (tides_channel), the same for each
# isomip (the ice shelf, SIGMA_SHELF_ZSTAR), tc1 (the layered benchmark
# with VarMix), tc2 and nonbouss_basin (JHL, PPM_IH4 on T, S and, tc2's
# fourth entry, the ideal age), the same
RUNDIR_CONFIGS = {"dense_water": (2, False, "ale"),
                  "tc4": (3, False, "ale"),
                  "adjustment": (2, False, "ale"),
                  "scm_lt": (2, False, "ale"),
                  "layered_bml": (3, False, "bulkml"),
                  "hycom_basin": (3, True, "ale_pqm"),
                  "spherical_gyre": (2, False, "ale_adaptive"),
                  "tides_channel": (2, False, "ale_itides"),
                  "isomip": (3, False, "ale"),
                  "tc1": (4, True, "bulkml"),
                  "tc2": (2, True, "ale_jhl_ih4", 3),
                  "nonbouss_basin": (2, True, "ale_jhl_ih4", 2)}


# wave_speed's Thomas solves a call: the internal tides' mode speed each
# thermo cycle (INTERNAL_TIDE_MODES = 1)
WAVE_SPEED_SOLVES = inspect.signature(wave_speed).parameters[
    "n_iter"].default
def kappa_shear_solves():
    """kappa_shear's Thomas solves a call: two a sweep of the kappa and
    TKE equations, n_inner sweeps and one solve of u, v, T and S an outer
    pass."""
    from mom6_tpu_torch.physics.vertical.kappa_shear import KappaShearParams
    p = KappaShearParams()
    return p.n_outer * (2 * p.n_inner + 1)


# per thermo cycle of the global path (6 baroclinic steps)
PER_GLOBAL_CYCLE = fold_cycle(6)
# a post of the table at 720x400x32 (global_half_deg, 6 steps a cycle)
PER_TABLE_POST = table_post(6)
# wave_speed's Thomas solves at (nz-1, ny, nx): global_2deg's and
# global_half_deg's, and tides_channel's (the internal tides' mode speed)
WAVE_TRIDIAG = ((19, 100, 180), (31, 400, 720), (9, 12, 40))
META = {
    "tridiag": ("mom6_tpu_torch/csrc/tridiag.cu",
                "mom6_tpu/framework/pallas_tridiag.py:35"),
    "ppm_edges_x": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                    "mom6_tpu/core/pallas_continuity.py:120"),
    "ppm_flux_x": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                   "mom6_tpu/core/pallas_continuity.py:120"),
    "ppm_edges_y": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                    "mom6_tpu/core/pallas_continuity.py:174"),
    "ppm_flux_y": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                   "mom6_tpu/core/pallas_continuity.py:174"),
    "remap": ("mom6_tpu_torch/csrc/remap.cu",
              "mom6_tpu/ale/remap_pallas.py:44"),
}
META["remap_npoly5"] = META["remap"]
META["ppm_edges_y_fold"] = META["ppm_edges_y"]
META["ppm_flux_y_fold"] = META["ppm_flux_y"]
# the y edges' HALO form on a mesh tile ([mesh])
META["ppm_edges_y_halo"] = META["ppm_edges_y"]
# kernel against plain version on the card: the same operations in the
# same order (nvcc --fmad=false), so every kernel must be bitwise equal to
# its plain version (0 ulps)
# the card's published peaks (H100 SXM data sheet, at a 700 W limit):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# times [ms] of the kernels by label, for the JSON line of --kernels
TIMES = {}
# every checked shape's row of each kernel, for the JSON line
SHAPE_ROWS = {}
# float32 operations per element, counted from the kernels' sources:
# Thomas 7 forward + 2 backward; the PPM edges with the positive-definite
# limiter one slope of 25, 8 for the edges, 22 for the limiter; the PPM
# flux with dw*rem 44
FLOPS_PER_POINT = {"tridiag": 9, "ppm_edges": 55, "ppm_flux": 44}
# (name, monotonic, simple_2nd) of the three PPM limiters
LIMITERS = (("pos", False, False), ("cw84", True, False),
            ("simple2nd", False, True))


def log(msg):
    print(msg, flush=True)


# repetitions of a plain version's timing (a reference beside the kernel's
# 20; a plain remap at 720x400x32 takes 20-55 ms a call)
PLAIN_REPS = 5


def median_ms(fn, reps=20, warm=3):
    """Median of per-call device times [ms] from CUDA events."""
    for _ in range(warm):
        fn()
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


# the profiler's host-side entry for launches that stood blocked because
# the device's command buffer was full: the host was ahead of the device
_BLOCKED = "Command Buffer Full"


def _device_activity(fn):
    """Run ``fn()`` under torch.profiler recording the device's activity
    only, and sum its raw events: (device ns, device events, ns the host
    stood blocked on a full command buffer, {name: (ns, events)}).  The
    host's operators are not recorded and key_averages is not called:
    none of these numbers reads them, and recording and averaging them
    took ~50 s for a global cycle of ~93,600 kernels on the H100's host,
    where the cycle itself takes ~1.5 s (tools/torch_profile_cost.py)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ns, n_ev, blocked_ns, by_name = 0, 0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ns = e.duration_ns()
            dev_ns += ns
            n_ev += 1
            t, c = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + ns, c + 1)
        elif e.name() == _BLOCKED:
            blocked_ns += e.duration_ns()
    return dev_ns, n_ev, blocked_ns, by_name


def device_ms(fn, name, n=10):
    """Device time [ms] per call of ``fn`` spent in the kernels whose name
    holds ``name``, from the profiler's device activity over ``n`` calls
    (:func:`_device_activity`).  :func:`median_ms` times one call from an
    idle device and so includes the host's enqueue, which is most of a
    short launch.  The tracer now and then records no kernel at all: the
    profile is then taken again, and after three empty ones the time is
    NaN, not measured (that the kernel ran and what it returned is
    checked elsewhere)."""
    fn()
    for _ in range(3):
        by_name = _device_activity(lambda: [fn() for _ in range(n)])[3]
        mine = [ns for k, (ns, _) in by_name.items() if name in k]
        if mine:
            return sum(mine) / 1e6 / n
    log(f"[kernel] the profiler recorded no {name} in three profiles: its "
        f"device time is not measured")
    return float("nan")


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def max_ulps(a, b):
    """Largest distance in units of the last place between two float32
    tensors (0 when bitwise equal)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    # map the sign-magnitude float order onto a monotonic integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def bound(nbytes, nflops):
    """(least time [ms] the card could take, what bounds it): bytes over
    the memory rate against float32 operations over the peak rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nflops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.time()
    so = kernels.build()
    kernels.library()
    secs = time.time() - t0
    with open(so + ".log") as f:
        report = f.read()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        f.write(report)
    entries = _ptxas_entries(report)
    regs = [e["registers"] for e in entries]
    spills = sum(e["spill_stores"] for e in entries)
    log(f"[build] {os.path.basename(so)} in {secs:.1f} s "
        f"(nvcc {kernels.BUILD_SECONDS or 0.0:.1f} s, {len(kernels.SOURCES)} "
        f"sources in parallel): {len(regs)} kernel instances, "
        f"{min(regs)}-{max(regs)} registers per thread, {spills} bytes of "
        f"spill stores")
    for family, note in (
            ("thomas_kernel", " (the per-column arrays are dynamic shared "
             "memory, sized at the launch)"),
            ("remap_kernel", " (the per-column sums are dynamic shared "
             "memory, sized at the launch)"),
            ("ppm_edges_kernel", " (the tiles' h, mask and slopes)")):
        mine = [e for e in entries if family in e["name"]]
        if not mine:
            raise AssertionError(f"ptxas reported no {family}")
        r = [e["registers"] for e in mine]
        spilled = sum(e["spill_stores"] + e["spill_loads"] for e in mine)
        log(f"[build] {family}: {len(mine)} instances, {min(r)}-{max(r)} "
            f"registers per thread, {max(e['stack'] for e in mine)} bytes "
            f"of stack, {spilled} bytes of spills, "
            f"{max(e['smem'] for e in mine)} bytes of static shared "
            f"memory{note}")
        if spilled:
            raise AssertionError(f"{family} spills {spilled} bytes")


def _ptxas_entries(report):
    """One dict per kernel instance of ``nvcc -Xptxas -v``'s report."""
    entries = []
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entries.append(dict(name=ln.split("'")[1], registers=0, stack=0,
                                spill_stores=0, spill_loads=0, smem=0))
        elif not entries:
            continue
        elif "bytes spill stores" in ln:
            n = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            entries[-1].update(stack=n[0], spill_stores=n[1],
                               spill_loads=n[2])
        elif "Used" in ln and "registers" in ln:
            entries[-1]["registers"] = int(ln.split("Used")[1].split()[0])
            if "bytes smem" in ln:
                entries[-1]["smem"] = int(
                    ln.split("bytes smem")[0].replace(",", " ").split()[-1])
    return entries


def _tridiag_inputs(shape, seed, dev):
    rng = np.random.default_rng(seed)
    a = -rng.uniform(0.0, 1.0, shape)
    c = -rng.uniform(0.0, 1.0, shape)
    a[0] = 0.0
    c[-1] = 0.0
    b = 1.0 + np.abs(a) + np.abs(c) + rng.uniform(0.0, 1.0, shape)
    d = rng.standard_normal(shape)
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (a, b, c, d)]


def _ppm_inputs(shape, seed, dev, reentrant_y=False):
    """A double-gyre-like stack: resting layers plus 30 m noise with a few
    near-massless cells, the double gyre's masks and metrics (with
    ``reentrant_y`` those of the same basin periodic in y)."""
    nz, ny, nx = shape
    G, GV, _, params, _ = double_gyre(nx=nx, ny=ny, nz=nz,
                                      len_lon_km=4500.0, len_lat_km=3500.0,
                                      dtype=torch.float32, device=dev)
    if reentrant_y:
        G = build_cartesian_grid(nx, ny, 4500.0, 3500.0, max_depth=2000.0,
                                 f0=1e-4, beta=2e-11, reentrant_y=True,
                                 dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    h = 2000.0 / nz + 30.0 * rng.standard_normal(shape)
    h[-1, : ny // 4] = 1e-10
    h = np.maximum(h, 1e-10)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return dict(G=G, dt=params.dt, h=t(h), u=t(0.3 * rng.standard_normal(shape)),
                dw=t(0.05 * rng.standard_normal(shape[1:])),
                rem=t(rng.uniform(0.2, 1.0, shape)))


def _kernel_row(err, ms, d_ms, pms, nbytes, nflops, shape):
    """A kernel's row of the JSON line: ``ms`` from an idle device,
    ``d_ms`` the kernel's own device time."""
    b_ms, b_by = bound(nbytes, nflops)
    return dict(max_abs_err=err, ms=ms, device_ms=d_ms, plain_ms=pms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=list(shape))


def _keep(results, name, shape, row):
    """Keep ``row`` for the JSON line if ``shape`` is the one the kernel's
    path gives it, and among the kernel's rows at every shape."""
    SHAPE_ROWS.setdefault(name, []).append(row)
    if tuple(shape) == ROW_SHAPE.get(name, GLOBAL_SHAPE):
        results[name] = row


def _check_tridiag_ppm(shape, dev, results, reentrant_y=False):
    n = math.prod(shape)
    a, b, c, d = _tridiag_inputs(shape, 1, dev)
    x_k = solvers.tridiag_solve(a, b, c, d)
    x_p = solvers.tridiag_solve_plain(a, b, c, d)
    torch.cuda.synchronize()
    err, ulps = rel_err(x_k, x_p), max_ulps(x_k, x_p)
    ms = median_ms(lambda: solvers.tridiag_solve(a, b, c, d))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, d),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, d),
                    PLAIN_REPS, warm=1)
    row = _kernel_row(float((x_k - x_p).abs().max()), ms, d_ms, pms,
                      4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n, shape)
    log(f"[kernel] tridiag {shape}: max rel err {err:.3e}, max ulps {ulps} "
        f"(must be 0); "
        f"kernel {ms:.4f} ms ({d_ms:.4f} ms on the device), plain {pms:.4f} "
        f"ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    if ulps != 0:
        raise AssertionError(f"tridiag {shape}: {ulps} ulps, err {err}")
    TIMES[f"tridiag {shape}"] = ms
    TIMES[f"tridiag {shape} device"] = d_ms
    _keep(results, "tridiag", shape, row)

    P = _ppm_inputs(shape, 2, dev, reentrant_y)
    G, dt, h, u = P["G"], P["dt"], P["h"], P["u"]
    for dname, edges, flux, face, d_p, d_m in (
            ("x", cppm.zonal_edges, cppm.zonal_flux,
             G.dyCu * G.mask2dCu, dt * G.IdxT,
             dt * torch.roll(G.IdxT, -1, -1)),
            ("y", cppm.merid_edges, cppm.merid_flux,
             G.dxCv * G.mask2dCv, dt * G.IdyT,
             dt * torch.roll(G.IdyT, -1, -2))):
        direction = cppm._DIR_X if dname == "x" else cppm._DIR_Y
        tag = " (periodic in y)" if reentrant_y else ""
        e_row = _check_edges(
            f"ppm_edges_{dname}{tag}", shape,
            lambda mono, s2: edges(h, G.mask2dT, 1e-10, mono, s2),
            lambda mono, s2: cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, mono,
                                                  s2, direction), h)
        hl, hr = edges(h, G.mask2dT, 1e-10)
        f_row = _check_flux(
            f"ppm_flux_{dname}{tag}", shape,
            lambda **kw: flux(h, hl, hr, face, d_p, d_m, u, **kw),
            lambda dw, rem: cppm.ppm_flux_plain(h, hl, hr, face, d_p, d_m, u,
                                                dw, rem, direction),
            P["dw"], P["rem"])
        _keep(results, f"ppm_edges_{dname}", shape, e_row)
        _keep(results, f"ppm_flux_{dname}", shape, f_row)


def _check_edges(label, shape, kernel, plain, h):
    """The edge kernel ``kernel(monotonic, simple_2nd)`` of ``h`` against
    its plain version ``plain(...)`` for each limiter: 0 ulps.  Times and
    the row with the positive-definite limiter; beside them, as a yardstick
    of what the card's memory gives this traffic, the device time of one
    PyTorch call that moves the same bytes (``torch.frexp``: reads one
    field, writes two of its size)."""
    n, plane = math.prod(shape), shape[1] * shape[2]
    errs = []
    for lim, mono, s2 in LIMITERS:
        hl_k, hr_k = kernel(mono, s2)
        hl_p, hr_p = plain(mono, s2)
        e = max(rel_err(hl_k, hl_p), rel_err(hr_k, hr_p))
        ul = max(max_ulps(hl_k, hl_p), max_ulps(hr_k, hr_p))
        log(f"[kernel] {label} {lim} {shape}: max rel err {e:.3e}, max ulps "
            f"{ul} (must be 0)")
        if ul != 0:
            raise AssertionError(f"{label} {lim} {shape}: {ul} ulps, err {e}")
        errs.append(float(max((hl_k - hl_p).abs().max(),
                              (hr_k - hr_p).abs().max())))
    ms = median_ms(lambda: kernel(False, False))
    d_ms = device_ms(lambda: kernel(False, False), "ppm_edges_kernel")
    pms = median_ms(lambda: plain(False, False),
                    PLAIN_REPS, warm=1)
    f_ms = device_ms(lambda: torch.frexp(h), "")
    row = _kernel_row(max(errs), ms, d_ms, pms, 4 * (3 * n + plane),
                      FLOPS_PER_POINT["ppm_edges"] * n, shape)
    log(f"[kernel] {label} {shape}: kernel {ms:.4f} ms ({d_ms:.4f} ms on "
        f"the device), plain {pms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); torch.frexp, the same bytes, {f_ms:.4f} ms "
        f"on the device")
    TIMES[f"{label} {shape}"] = ms
    TIMES[f"{label} {shape} device"] = d_ms
    TIMES[f"{label} {shape} frexp device"] = f_ms
    return row


def _check_flux(label, shape, kernel, plain, dw, rem, face3d=False):
    """The flux kernel ``kernel(**kw)`` at w = u and at u + dw*rem against
    its plain version ``plain(dw, rem)``: 0 ulps.  Times and the row at
    u + dw*rem; with ``face3d`` the face is (nz, ny, nx), one field more
    to read and one plane less."""
    n, plane = math.prod(shape), shape[1] * shape[2]
    errs = []
    for adj in (False, True):
        kw = dict(dw=dw, rem=rem) if adj else {}
        f_k = kernel(**kw)
        f_p = plain(kw.get("dw"), kw.get("rem"))
        e = max(rel_err(f_k[0], f_p[0]), rel_err(f_k[1], f_p[1]))
        ul = max(max_ulps(f_k[0], f_p[0]), max_ulps(f_k[1], f_p[1]))
        log(f"[kernel] {label} adjust={adj} {shape}: max rel err {e:.3e}, "
            f"max ulps {ul} (must be 0)")
        if ul != 0:
            raise AssertionError(f"{label} adjust={adj} {shape}: {ul} ulps, "
                                 f"err {e}")
        errs.append(float(max((f_k[0] - f_p[0]).abs().max(),
                              (f_k[1] - f_p[1]).abs().max())))
    ms = median_ms(lambda: kernel(dw=dw, rem=rem))
    d_ms = device_ms(lambda: kernel(dw=dw, rem=rem), "ppm_flux_kernel")
    pms = median_ms(lambda: plain(dw, rem),
                    PLAIN_REPS, warm=1)
    nbytes = 4 * ((8 * n + 3 * plane) if face3d else (7 * n + 4 * plane))
    row = _kernel_row(max(errs), ms, d_ms, pms, nbytes,
                      FLOPS_PER_POINT["ppm_flux"] * n, shape)
    if face3d:
        row["face"] = "per-layer"
    log(f"[kernel] {label} adjust=True {shape}: kernel {ms:.4f} ms "
        f"({d_ms:.4f} ms on the device), plain {pms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    TIMES[f"{label} {shape}"] = ms
    TIMES[f"{label} {shape} device"] = d_ms
    return row


def _check_tridiag_wave(shape, dev):
    """The Thomas kernel as wave_speed calls it, at (nz-1, ny, nx): the
    mode operator of random thicknesses (diagnostics/wave_speed.py::
    _mode_operator), float32 and float64, bitwise against its plain
    version; the float32 times."""
    from mom6_tpu_torch.diagnostics.wave_speed import _mode_operator
    n = math.prod(shape)
    rng = np.random.default_rng(11)
    nz1, ny, nx = shape
    h = np.maximum(4000.0 / (nz1 + 1) * rng.uniform(0.0, 2.0,
                                                     (nz1 + 1, ny, nx)), 0.0)
    h[:, : ny // 8] = 1e-10               # land columns, as on the grid
    d = rng.standard_normal(shape)
    for dtype in (torch.float64, torch.float32):
        a, b, c = _mode_operator(torch.tensor(h, dtype=dtype, device=dev))
        rhs = torch.tensor(d, dtype=dtype, device=dev)
        x_k = solvers.tridiag_solve(a, b, c, rhs)
        x_p = solvers.tridiag_solve_plain(a, b, c, rhs)
        torch.cuda.synchronize()
        if not torch.equal(x_k, x_p):
            raise AssertionError(f"tridiag (nz-1) {shape} {dtype}: max abs "
                                 f"diff {float((x_k - x_p).abs().max())}")
    ms = median_ms(lambda: solvers.tridiag_solve(a, b, c, rhs))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, rhs),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, rhs),
                    PLAIN_REPS, warm=1)
    b_ms, b_by = bound(4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n)
    log(f"[kernel] tridiag as wave_speed calls it, (nz-1) = {shape}: float64 "
        f"and float32 bitwise equal to the plain version; kernel {ms:.4f} "
        f"ms ({d_ms:.4f} ms on the device), plain {pms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); {WAVE_SPEED_SOLVES} solves a call")
    TIMES[f"tridiag wave {shape}"] = ms
    TIMES[f"tridiag wave {shape} device"] = d_ms
    SHAPE_ROWS.setdefault("tridiag", []).append(dict(
        form="wave_speed's mode operator", max_abs_err=0.0, ms=ms,
        device_ms=d_ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=list(shape)))


def _check_tridiag_shared(dev, shape):
    """The Thomas solve as tracers/vert_diff.py calls it: coefficients
    (nz, 1, ny, nx) shared by the n_tr right-hand sides of the transposed
    view of an (n_tr, nz, ny, nx) tensor ``shape``.  Its bound reads a, b,
    c once and reads and writes each right-hand side once: 3 + 2 n_tr
    passes."""
    n_tr, nz, ny, nx = shape
    n = nz * ny * nx
    a, b, c, _ = (t[:, None] for t in _tridiag_inputs((nz, ny, nx), 7, dev))
    rng = np.random.default_rng(8)
    d = torch.tensor(rng.standard_normal(shape),
                     dtype=torch.float32, device=dev).transpose(0, 1)
    x_p = solvers.tridiag_solve_plain(a, b, c, d)
    solvers.tridiag_solve(a, b, c, d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    x_k = solvers.tridiag_solve(a, b, c, d)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    x_bytes = x_k.numel() * x_k.element_size()
    err, ulps = rel_err(x_k, x_p), max_ulps(x_k, x_p)
    each = [solvers.tridiag_solve(a[:, 0], b[:, 0], c[:, 0],
                                  d[:, r].contiguous()) for r in range(n_tr)]
    same = all(torch.equal(x_k[:, r], e) for r, e in enumerate(each))
    ms = median_ms(lambda: solvers.tridiag_solve(a, b, c, d))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, d),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, d), reps=5)
    b_ms, b_by = bound(4 * (3 + 2 * n_tr) * n, (3 + 5 * n_tr) * n)
    log(f"[kernel] tridiag, coefficients ({nz}, 1, {ny}, {nx}) shared by the "
        f"{n_tr} right-hand sides of a transposed {shape} tensor: "
        f"max rel err {err:.3e}, max ulps {ulps} (must be 0), equal to one "
        f"solve per right-hand side {same}; the call held {extra} bytes "
        f"beyond its inputs, {extra / x_bytes:.3f} of x's {x_bytes}; kernel "
        f"{ms:.4f} ms ({d_ms:.4f} ms on the device), plain {pms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if ulps != 0 or not same:
        raise AssertionError(f"shared tridiag: {ulps} ulps, per-rhs {same}")
    # (another checkout is timed, not held to this: the parent copies)
    if TREE == REPO and extra > x_bytes + 512:
        raise AssertionError("tridiag_solve allocated a scratch tensor or "
                             "copied an operand")
    TIMES[f"tridiag shared {shape}"] = ms
    TIMES[f"tridiag shared {shape} device"] = d_ms
    SHAPE_ROWS.setdefault("tridiag", []).append(dict(
        form="coefficients shared by the right-hand sides",
        max_abs_err=float((x_k - x_p).abs().max()), ms=ms, device_ms=d_ms,
        plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=list(shape)))


def _check_tridiag_split(dev, shape):
    """The Thomas solve as tracers/vert_diff.py calls it with per-tracer
    diffusivities: a, b, c of shape (nz, n_tr, ny, nx), each column its
    own, against the transposed view of an (n_tr, nz, ny, nx) tensor
    ``shape``: the kernel's unshared instance over n_tr ny nx columns.
    Bitwise against the plain version and against one solve per tracer;
    its bound reads a, b, c and d once and writes x once: 5 passes."""
    n_tr, nz, ny, nx = shape
    n = n_tr * nz * ny * nx
    a, b, c, _ = _tridiag_inputs((nz, n_tr, ny, nx), 9, dev)
    rng = np.random.default_rng(10)
    d = torch.tensor(rng.standard_normal(shape),
                     dtype=torch.float32, device=dev).transpose(0, 1)
    x_p = solvers.tridiag_solve_plain(a, b, c, d)
    x_k = solvers.tridiag_solve(a, b, c, d)
    torch.cuda.synchronize()
    err, ulps = rel_err(x_k, x_p), max_ulps(x_k, x_p)
    each = [solvers.tridiag_solve(a[:, r].contiguous(), b[:, r].contiguous(),
                                  c[:, r].contiguous(), d[:, r].contiguous())
            for r in range(n_tr)]
    same = all(torch.equal(x_k[:, r], e) for r, e in enumerate(each))
    ms = median_ms(lambda: solvers.tridiag_solve(a, b, c, d))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, d),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, d), reps=5)
    b_ms, b_by = bound(4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n)
    log(f"[kernel] tridiag, per-tracer coefficients ({nz}, {n_tr}, {ny}, "
        f"{nx}) against a transposed {shape} tensor (double diffusion's "
        f"split T/S solve): max rel err {err:.3e}, max ulps {ulps} (must be "
        f"0), equal to one solve per tracer {same}; kernel {ms:.4f} ms "
        f"({d_ms:.4f} ms on the device), plain {pms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    if ulps != 0 or not same:
        raise AssertionError(f"split tridiag: {ulps} ulps, per-tracer {same}")
    TIMES[f"tridiag split {shape}"] = ms
    TIMES[f"tridiag split {shape} device"] = d_ms
    SHAPE_ROWS.setdefault("tridiag", []).append(dict(
        form="per-tracer coefficients (double diffusion)",
        max_abs_err=float((x_k - x_p).abs().max()), ms=ms, device_ms=d_ms,
        plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=list(shape)))


def _captured_solves(module, fn):
    """The (a, b, c, d) of every tridiag_solve that ``fn()`` makes through
    ``module``'s name for it."""
    seen = []
    orig = module.tridiag_solve

    def record(a, b, c, d):
        seen.append((a, b, c, d))
        return orig(a, b, c, d)
    module.tridiag_solve = record
    try:
        fn()
    finally:
        module.tridiag_solve = orig
    return seen


def _check_tridiag_adaptive(dev):
    """The Thomas kernel as the ADAPTIVE coordinate calls it: the
    smoothing system of spherical_gyre's interfaces, (nz-1, ny, nx) =
    (9, 24, 30), on its built state under a seeded flow's advection
    (one cycle from it), float32 and float64 bitwise against the plain
    version; the float32 times."""
    from mom6_tpu_torch.ale import regridding
    shape = None
    for dtype in (torch.float64, torch.float32):
        ms = build_model_from_params(ParamFile([os.path.join(
            TREE, "configs", "spherical_gyre", "MOM_input")]), dtype=dtype,
            device=dev)
        st = _flowing(ms.state, ms.grid)
        with torch.inference_mode():
            st = step_mom(st, ms.forcing, ms.grid, ms.vgrid, ms.params)
            ap = regridding.AdaptParams(
                **{f.name: getattr(ms.params.ale, "adapt_" + f.name)
                   for f in dataclasses.fields(regridding.AdaptParams)})
            seen = _captured_solves(regridding, lambda: (
                regridding.build_adaptive_grid(
                    st.h, st.T, st.S, ms.grid, ms.vgrid,
                    get_eos(ms.params.eos_name), ap)))
        if len(seen) != 1:
            raise AssertionError(f"ADAPTIVE: {len(seen)} solves")
        a, b, c, d = seen[0]
        shape = tuple(d.shape)
        x_k = solvers.tridiag_solve(a, b, c, d)
        x_p = solvers.tridiag_solve_plain(a, b, c, d)
        torch.cuda.synchronize()
        if not torch.equal(x_k, x_p):
            raise AssertionError(f"tridiag ADAPTIVE {shape} {dtype}: max "
                                 f"abs diff "
                                 f"{float((x_k - x_p).abs().max())}")
    n = math.prod(shape)
    ms_ = median_ms(lambda: solvers.tridiag_solve(a, b, c, d))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, d),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, d),
                    PLAIN_REPS, warm=1)
    b_ms, b_by = bound(4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n)
    log(f"[kernel] tridiag as the ADAPTIVE coordinate calls it on "
        f"spherical_gyre, {shape}: float64 and float32 bitwise equal to "
        f"the plain version; kernel {ms_:.4f} ms ({d_ms:.4f} ms on the "
        f"device), plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); one "
        f"solve a cycle")
    TIMES[f"tridiag adaptive {shape}"] = ms_
    TIMES[f"tridiag adaptive {shape} device"] = d_ms
    SHAPE_ROWS.setdefault("tridiag", []).append(dict(
        form="the ADAPTIVE coordinate's smoothing", max_abs_err=0.0,
        ms=ms_, device_ms=d_ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=list(shape)))


def _check_fold(G, dt, h, dev, results):
    """The y edges and the y flux (plain and at v + dw*rem) across the
    tripolar fold of grid ``G``, through their wrappers, against the plain
    versions; same bytes and operations as the wrap rows."""
    shape = tuple(h.shape)
    rng = np.random.default_rng(4)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    v = t(0.3 * rng.standard_normal(shape)) * G.mask2dCv
    dw = t(0.05 * rng.standard_normal(shape[1:]))
    rem = t(rng.uniform(0.2, 1.0, shape))
    face, d_p = G.dxCv * G.mask2dCv, dt * G.IdyT
    d_m = dt * jp1(G.IdyT, "h")
    edges, flux = cppm.merid_edges, cppm.merid_flux
    before = (edges.fold_launches, flux.fold_launches, edges.launches,
              flux.launches)
    e_row = _check_edges(
        "ppm_edges_y_fold", shape,
        lambda mono, s2: edges(h, G.mask2dT, 1e-10, mono, s2, fold=True),
        lambda mono, s2: cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, mono, s2,
                                              cppm._DIR_Y, fold=True), h)
    hl, hr = edges(h, G.mask2dT, 1e-10, fold=True)
    # the fold is not the wrap: the top row's north edge differs
    _, hr_w = cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, False, False,
                                   cppm._DIR_Y)
    if torch.equal(hr_w[:, -1], hr[:, -1]):
        raise AssertionError("fold edges equal the wrap's on the top row")
    f_row = _check_flux(
        "ppm_flux_y_fold", shape,
        lambda **kw: flux(h, hl, hr, face, d_p, d_m, v, fold=True, **kw),
        lambda dw_, rem_: cppm.ppm_flux_plain(h, hl, hr, face, d_p, d_m, v,
                                              dw_, rem_, cppm._DIR_Y,
                                              fold=True),
        dw, rem)
    after = (edges.fold_launches, flux.fold_launches, edges.launches,
             flux.launches)
    if not (after[0] > before[0] and after[1] > before[1]
            and after[2:] == before[2:]):
        raise AssertionError(f"fold launches miscounted: {before} -> {after}")
    _keep(results, "ppm_edges_y_fold", shape, e_row)
    _keep(results, "ppm_flux_y_fold", shape, f_row)


def _remap_inputs(shape, seed, dev, nz1=None, ties=False):
    """A z* column stack of nz0 layers over 3000 m with 30% noise and
    vanished bottom layers on a quarter of the plane, a target grid of
    ``nz1`` layers (nz0 unless given) renormalised to the same column sums
    or, with ``ties``, the source grid itself, and T/S-like fields."""
    nf, nz0, ny, nx = shape
    rng = np.random.default_rng(seed)
    h0 = (3000.0 / nz0) * (1.0 + 0.3 * rng.uniform(-1, 1, (nz0, ny, nx)))
    h0[-2:, : ny // 4] = 1e-10
    w = 1.0 + 0.3 * rng.uniform(-1, 1, (nz1 or nz0, ny, nx))
    h1 = w / w.sum(0, keepdims=True) * h0.sum(0, keepdims=True)
    if ties:
        h1 = h0
    zc = np.cumsum(h0, 0) - 0.5 * h0
    base = [4.0 + 16.0 * np.exp(-zc / 800.0), 35.0 + 0 * zc]
    f = np.stack([base[i % 2] + 0.1 * rng.standard_normal(zc.shape)
                  for i in range(nf)])
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return t(f), t(h0), t(h1)


def _hycom_remap_inputs(shape, dev):
    """hycom_basin's columns on the card: its T and S profile with noise
    on noisy z* thicknesses, the target grid of its HYCOM1 coordinate
    (TEOS10, its targets and nominal z*: interfaces that tie or cross the
    nominal ones), T and S (nf = 2) or T (nf = 1)."""
    nf, nz0, ny, nx = shape
    ms = build_model_from_params(ParamFile([os.path.join(
        TREE, "configs", "hycom_basin", "MOM_input")]), device=dev)
    p, st = ms.params, ms.state
    rng = np.random.default_rng(9)
    h0 = _noisy_thickness(st.h, 10)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    T = st.T + t(0.5 * rng.standard_normal(tuple(st.T.shape)))
    S = st.S + t(0.05 * rng.standard_normal(tuple(st.S.shape)))
    h1 = build_hycom1_grid(h0, T, S, ms.vgrid, get_eos(p.eos_name),
                           p.ale.rho_targets, p.ale.dz_nominal)
    if tuple(h0.shape) != (nz0, ny, nx):
        raise AssertionError(f"hycom_basin is {tuple(h0.shape)}")
    return torch.stack([T, S][:nf]), h0, h1


def _remap_work(nf, npoly, nz0, nz1, cols):
    """(bytes, float32 operations) of a remap launch: each input read once
    and the output written once; the operations as an O(nz0 + nz1) merge
    over the monotone interfaces would do them: xi at each target
    interface (5, shared by the fields), per field each source cell's
    whole integral once (npoly + 1) and one partial integral per target
    interface (2(npoly-1) + 3), then 3 per output cell."""
    nbytes = 4 * cols * (nf * npoly * nz0 + nz0 + nz1 + 2 * nf + nf * nz1)
    nflops = cols * (5 * (nz1 + 1) + nf * (
        (npoly + 1) * nz0 + (2 * (npoly - 1) + 3) * (nz1 + 1) + 3 * nz1))
    return nbytes, nflops


def _check_remap(shape, dev, results, scheme=remap.PPM_H4, hycom=False,
                 **form):
    """The wrapper remap_columns_multi (reconstruction, then one launch)
    against the reconstruction and the plain version; the times are of the
    launch alone against the plain version alone, then of both with the
    reconstruction.  ``form``: see :func:`_remap_inputs`; ``hycom``:
    :func:`_hycom_remap_inputs`."""
    nf, nz0, ny, nx = shape
    f, h0, h1 = _hycom_remap_inputs(shape, dev) if hycom else \
        _remap_inputs(shape, 3, dev, **form)
    wrapper = remap.remap_columns_multi

    def plain_whole():
        c, lo_, hi_ = remap.remap_coefficients(f, h0, scheme)
        return remap.remap_integrals_plain(c, h0, h1, lo_, hi_)

    coef, lo, hi = remap.remap_coefficients(f, h0, scheme)
    npoly, nz1, cols = coef.shape[1], h1.shape[0], ny * nx
    def counted():
        return wrapper.launches, wrapper.quartic_launches
    before = counted()
    out_k = wrapper(f, h0, h1, scheme)
    after = counted()
    if after != (before[0] + 1, before[1] + int(npoly == 5)):
        raise AssertionError(f"remap {shape} {scheme}: the wrapper counted "
                             f"{after[0] - before[0]} launches, "
                             f"{after[1] - before[1]} quartic")
    out_p = remap.remap_integrals_plain(coef, h0, h1, lo, hi)
    torch.cuda.synchronize()
    err, ulps = rel_err(out_k, out_p), max_ulps(out_k, out_p)
    ms = median_ms(lambda: remap._remap_launch(coef, h0, h1, lo, hi))
    d_ms = device_ms(lambda: remap._remap_launch(coef, h0, h1, lo, hi),
                     "remap_kernel")
    pms = median_ms(lambda: remap.remap_integrals_plain(coef, h0, h1, lo,
                                                        hi), reps=5)
    w_ms = median_ms(lambda: wrapper(f, h0, h1, scheme), reps=5)
    wp_ms = median_ms(plain_whole, reps=5)
    nbytes, nflops = _remap_work(nf, npoly, nz0, nz1, cols)
    row = _kernel_row(float((out_k - out_p).abs().max()), ms, d_ms, pms,
                      nbytes, nflops, shape)
    what = (f"nf={nf} ({nz0}, {ny}, {nx})"
            + (f" to {nz1} layers" if nz1 != nz0 else "")
            + (" onto the source grid (all ties)" if form.get("ties") else "")
            + (" onto hycom_basin's HYCOM1 targets" if hycom else "")
            + (f" npoly {npoly}" if npoly != 3 else ""))
    if npoly == 5:
        nq = int(((coef[:, 3] != 0) | (coef[:, 4] != 0)).sum())
        what += (f" ({scheme}: {nq} of {coef[:, 0].numel()} cells quartic, "
                 "the rest the PPM fallback)")
    log(f"[kernel] remap {what} {scheme}, wrapper (1 launch): max rel err "
        f"{err:.3e}, max ulps {ulps} (must be 0); launch {ms:.4f} ms "
        f"({d_ms:.4f} ms on the device), plain "
        f"{pms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{nbytes / 1e6:.1f} MB, {nflops / 1e9:.3f} GFLOP); with the "
        f"reconstruction: wrapper {w_ms:.4f} ms, plain {wp_ms:.4f} ms")
    if ulps != 0:
        raise AssertionError(f"remap {what}: {ulps} ulps, err {err}")
    TIMES[f"remap {what}"] = ms
    TIMES[f"remap {what} device"] = d_ms
    name = "remap_npoly5" if npoly == 5 else "remap"
    SHAPE_ROWS.setdefault(name, []).append(dict(row, form=what))
    if npoly == 5 and hycom and nf == 2:
        results["remap_npoly5"] = row
    elif npoly == 3 and shape == REMAP_SHAPES[0] and not form:
        results["remap"] = row


def _check_remap_site(tag, label, args):
    """A remap launch captured from a path (``args`` = coef, h0, h1, lo,
    hi as the wrapper gave them to the kernel): the kernel against the
    plain version in float32 (as captured) and float64, to the bit; the
    launch's time from an idle device, its device time, the plain
    version's and the card's bound for it, kept as a row of the kernel
    in the JSON line."""
    coef, h0, h1, lo, hi = args
    nf, npoly, nz0 = coef.shape[:3]
    nz1 = h1.shape[0]
    for dtype in (torch.float32, torch.float64):
        r = [t.to(dtype) for t in args]
        got = remap._remap_launch(*r)
        want = remap.remap_integrals_plain(*r)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[{tag}] captured remap {label} {dtype}: "
                                 f"not bitwise ({max_ulps(got, want)} ulps)")
    ms = median_ms(lambda: remap._remap_launch(*args))
    d_ms = device_ms(lambda: remap._remap_launch(*args), "remap_kernel")
    pms = median_ms(lambda: remap.remap_integrals_plain(*args), reps=5)
    nbytes, nflops = _remap_work(nf, npoly, nz0, nz1, h0[0].numel())
    shape = (nf, nz0) + tuple(h0.shape[1:])
    row = _kernel_row(0.0, ms, d_ms, pms, nbytes, nflops, shape)
    what = (f"{label}: nf={nf} ({nz0}, {h0.shape[1]}, {h0.shape[2]}) to "
            f"{nz1} layers npoly {npoly}, captured from [{tag}]")
    log(f"[kernel] remap {what}: kernel against plain 0 ulps in float32 "
        f"and float64; launch {ms:.4f} ms ({d_ms:.4f} ms on the device), "
        f"plain {pms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, {nflops / 1e9:.3f} "
        f"GFLOP)")
    TIMES[f"remap {what}"] = ms
    SHAPE_ROWS.setdefault("remap_npoly5" if npoly == 5 else "remap",
                          []).append(dict(row, form=what))


def _captured_remaps(run):
    """The inputs of every remap launch ``run()`` makes, in order (the
    launches go on, and are counted, as usual)."""
    seen = []
    orig = remap._remap_launch

    def record(*args):
        seen.append([t.clone() for t in args])
        return orig(*args)
    remap._remap_launch = record
    try:
        run()
    finally:
        remap._remap_launch = orig
    return seen


def _noisy_thickness(h, seed):
    """``h`` with 10% noise on the layers that hold water (the vanished
    layers over topography stay as they are)."""
    rng = np.random.default_rng(seed)
    noise = torch.tensor(1.0 + 0.1 * rng.uniform(-1, 1, tuple(h.shape)),
                         dtype=h.dtype, device=h.device)
    return torch.where(h > 1.0, h * noise, h)


def _has_slice12():
    """Whether the checkout driven has the ADAPTIVE coordinate, neutral
    diffusion and the internal tides (a parent given by --tree may
    not)."""
    return os.path.exists(os.path.join(
        TREE, "mom6_tpu_torch", "tracers", "neutral_diffusion.py"))


def _has_slice13():
    """Whether the checkout driven has JHL's kappa_shear and PPM_IH4 (a
    parent given by --tree may not)."""
    return os.path.exists(os.path.join(
        TREE, "mom6_tpu_torch", "physics", "vertical", "kappa_shear.py"))


def _has_slice16():
    """Whether the checkout driven has the per-tracer column solve."""
    return os.path.exists(os.path.join(TREE, "mom6_tpu_torch", "physics",
                                       "vertical", "convection.py"))


def _has_slice17():
    """Whether the checkout driven has the porous barriers (the PPM flux
    with a per-layer face) and the other lateral options."""
    return os.path.exists(os.path.join(TREE, "mom6_tpu_torch", "core",
                                       "porous_barriers.py"))


def _captured_systems(dtype, dev):
    """{form: [(a, b, c, d), ...]}: the Thomas solves of JHL's
    kappa_shear (its kappa and TKE systems, (nz-1, ny, nx), and its
    mixing of u, v, T and S, coefficients shared by the four) on tc2's
    state, and of PPM_IH4's edge systems ((nz+1, ny, nx), unit diagonal,
    one for each of T, S, u and v) on tc2's and nonbouss_basin's, each
    built in ``dtype`` and stepped one cycle under a seeded flow."""
    from mom6_tpu_torch.physics.vertical import kappa_shear as ks
    from mom6_tpu_torch.tracers import vert_diff
    out = {}
    for name in ("tc2", "nonbouss_basin"):
        ms = build_model_from_params(ParamFile([os.path.join(
            TREE, "configs", name, "MOM_input")]), dtype=dtype, device=dev)
        p = ms.params
        with torch.inference_mode():
            st = step_mom(_flowing(ms.state, ms.grid), ms.forcing, ms.grid,
                          ms.vgrid, p)
            if name == "tc2":
                def jhl():
                    return ks.kappa_shear(
                        st.h, st.u, st.v, st.T, st.S, ms.grid, ms.vgrid,
                        get_eos(p.eos_name),
                        dt=p.dyn.dt * p.n_dyn_per_thermo)
                out["kappa_shear's kappa and TKE systems (tc2)"] = \
                    _captured_solves(ks, jhl)
                out["kappa_shear's mixing of u, v, T and S (tc2)"] = \
                    _captured_solves(vert_diff, jhl)
            out[f"PPM_IH4's edge systems ({name})"] = _captured_solves(
                remap, lambda: ale_regrid_remap(st, ms.grid, ms.vgrid,
                                                p.ale))
    return out


def _check_tridiag_captured(dev):
    """The Thomas kernel at the systems of :func:`_captured_systems`,
    float64 and float32, every one bitwise against the plain version; the
    float32 times of each form's first system."""
    from mom6_tpu_torch.physics.vertical.kappa_shear import KappaShearParams
    kp = KappaShearParams()
    want = {"kappa_shear's kappa": 2 * kp.n_inner * kp.n_outer,
            "kappa_shear's mixing": kp.n_outer, "PPM_IH4's edge": 4}
    for dtype in (torch.float64, torch.float32):
        systems = _captured_systems(dtype, dev)
        for form, seen in systems.items():
            n_want = [v for k, v in want.items() if form.startswith(k)]
            if n_want and len(seen) != n_want[0]:
                raise AssertionError(f"{form}: {len(seen)} solves")
            for a, b, c, d in seen:
                x_k = solvers.tridiag_solve(a, b, c, d)
                x_p = solvers.tridiag_solve_plain(a, b, c, d)
                torch.cuda.synchronize()
                if not torch.equal(x_k, x_p):
                    raise AssertionError(
                        f"tridiag {form} {tuple(d.shape)} {dtype}: max abs "
                        f"diff {float((x_k - x_p).abs().max())}")
    for form, seen in systems.items():
        a, b, c, d = seen[0]
        shape = tuple(d.shape)
        n = math.prod(shape)
        if d.dim() == 4:                # (nz, n_tr, ny, nx), shared
            n_tr = shape[1]
            n1 = n // n_tr
            b_ms, b_by = bound(4 * (3 + 2 * n_tr) * n1, (3 + 5 * n_tr) * n1)
        else:
            b_ms, b_by = bound(4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n)
        ms_ = median_ms(lambda: solvers.tridiag_solve(a, b, c, d))
        d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, d),
                         "thomas_kernel")
        pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, d),
                    PLAIN_REPS, warm=1)
        log(f"[kernel] tridiag as {form} calls it, {shape}, "
            f"{len(seen)} solves a call: float64 and float32 bitwise equal "
            f"to the plain version; kernel {ms_:.4f} ms ({d_ms:.4f} ms on "
            f"the device), plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        TIMES[f"tridiag {form} {shape}"] = ms_
        TIMES[f"tridiag {form} {shape} device"] = d_ms
        SHAPE_ROWS.setdefault("tridiag", []).append(dict(
            form=form, max_abs_err=0.0, ms=ms_, device_ms=d_ms,
            plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=list(shape)))


def _check_porous_flux(G, dt, h, dev, direction, fold=False):
    """The flux kernel's instance with a face of each layer's own (the
    porous barriers' open fractions times the face width), through its
    wrapper, against the plain version: float32 timed, float64 bitwise
    too.  Its row joins the kernel's rows at every shape."""
    shape = tuple(h.shape)
    rng = np.random.default_rng(8)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    w = t(0.3 * rng.standard_normal(shape))
    dw = t(0.05 * rng.standard_normal(shape[1:]))
    rem = t(rng.uniform(0.2, 1.0, shape))
    por = t(rng.uniform(0.0, 1.0, shape))
    if direction == "x":
        name, edges, flux = "ppm_flux_x", cppm.zonal_edges, cppm.zonal_flux
        face, d_p = G.dyCu * G.mask2dCu, dt * G.IdxT
        d_m, d = dt * ip1(G.IdxT), cppm._DIR_X
        kw_f = {}
    else:
        name = "ppm_flux_y_fold" if fold else "ppm_flux_y"
        edges = functools.partial(cppm.merid_edges, fold=fold)
        flux = functools.partial(cppm.merid_flux, fold=fold)
        face, d_p = G.dxCv * G.mask2dCv, dt * G.IdyT
        d_m, d = dt * jp1(G.IdyT, "h" if fold else None), cppm._DIR_Y
        kw_f = dict(fold=fold)
    face = (face * por).contiguous()
    hl, hr = edges(h, G.mask2dT, 1e-10)
    row = _check_flux(
        f"{name} (per-layer face)", shape,
        lambda **kw: flux(h, hl, hr, face, d_p, d_m, w, **kw),
        lambda dw_, rem_: cppm.ppm_flux_plain(h, hl, hr, face, d_p, d_m, w,
                                              dw_, rem_, d, **kw_f),
        dw, rem, face3d=True)
    args = [x.double() for x in (h, hl, hr, face, d_p, d_m, w, dw, rem)]
    for adj in (False, True):
        kw = dict(dw=args[7], rem=args[8]) if adj else {}
        got = flux(*args[:7], **kw)
        want = cppm.ppm_flux_plain(*args[:7], kw.get("dw"), kw.get("rem"), d,
                                   **kw_f)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name} (per-layer face) float64 "
                                 f"adjust={adj} {shape}: not bitwise")
    log(f"[kernel] {name} (per-layer face) {shape}: float64 bitwise equal "
        f"to the plain version too")
    SHAPE_ROWS.setdefault(name, []).append(row)


def _check_porous_fluxes(ms, dev):
    """The flux with a per-layer face on the global model ``ms``'s grid,
    x and y across the fold, and periodic in y at POROUS_WRAP_SHAPE."""
    h = _noisy_thickness(ms.state.h, 9)
    for direction in ("x", "y"):
        _check_porous_flux(ms.grid, ms.params.dyn.dt, h, dev, direction,
                           fold=True)
    P = _ppm_inputs(POROUS_WRAP_SHAPE, 10, dev, reentrant_y=True)
    _check_porous_flux(P["G"], P["dt"], P["h"], dev, "y")


def phase_kernels(dev, ms):
    """Every kernel against its plain version on the card; the fold
    branch on the global model ``ms``'s grid and on a polar cap with an
    odd nx; the flux with a per-layer face (the porous barriers) on the
    global grid, x and y fold, and periodic in y at a small shape."""
    results = {}
    for shape in KERNEL_SHAPES + OBC_KERNEL_SHAPES + RUNDIR_KERNEL_SHAPES:
        _check_tridiag_ppm(shape, dev, results,
                           reentrant_y=shape in REENTRANT_Y_SHAPES)
        torch.cuda.empty_cache()
    _check_fold(ms.grid, ms.params.dyn.dt, _noisy_thickness(ms.state.h, 5),
                dev, results)
    G, _, _, p, _ = polar_cap_bump(**FOLD_CAP, device=dev)
    rng = np.random.default_rng(6)
    h = np.maximum(150.0 + 30.0 * rng.standard_normal((7, G.ny, G.nx)), 1e-10)
    h[-1, -4:, : G.nx // 3] = 1e-10
    _check_fold(G, p.dt, torch.tensor(h, dtype=torch.float32, device=dev),
                dev, results)
    if _has_slice17():
        _check_porous_fluxes(ms, dev)
    else:
        log(f"[kernel] {TREE} has no porous barriers: the flux's per-layer "
            f"face is not checked there")
    for shape in SHARED_TRIDIAG:
        _check_tridiag_shared(dev, shape)
    if _has_slice16():
        for shape in SPLIT_TRIDIAG:
            _check_tridiag_split(dev, shape)
    else:
        log(f"[kernel] {TREE} has no per-tracer diffusivities: the split "
            f"Thomas shape is not checked there")
    for shape in WAVE_TRIDIAG:
        _check_tridiag_wave(shape, dev)
    if _has_slice12():
        _check_tridiag_adaptive(dev)
    else:
        log(f"[kernel] {TREE} has no ADAPTIVE coordinate: its Thomas shape "
            f"is not checked there")
    if _has_slice13():
        _check_tridiag_captured(dev)
    else:
        log(f"[kernel] {TREE} has no kappa_shear nor PPM_IH4: their Thomas "
            f"systems are not checked there")
    for shape, form in [(sh, {}) for sh in REMAP_SHAPES] + list(REMAP_FORMS):
        _check_remap(shape, dev, results, **form)
        torch.cuda.empty_cache()
    for shape in PQM_REMAP_SHAPES:
        _check_remap(shape, dev, results, scheme=remap.PQM_IH4IH3,
                     hycom=shape[2:] == (18, 20))
        torch.cuda.empty_cache()
    return results


def phase_fold_exact(dev):
    """A mirror-symmetric bump on the pole of a cap without rotation: the
    evolution across the fold stays mirror-symmetric to the bit."""
    G, GV, s, p, eta0 = polar_cap_bump(device=dev)
    n0 = cppm.merid_flux.fold_launches
    with torch.inference_mode():
        for _ in range(10):
            s = step_dynamics_split_rk2(s, MechForcing(), G, GV, p)
    eta = (s.h.double().sum(0) - G.bathyT.double()) * G.mask2dT
    asym = float((eta - eta.flip(-1)).abs().max())
    log(f"[fold] polar cap {G.nx}x{G.ny}x1, no rotation, 10 steps: mirror "
        f"asymmetry of eta {asym:.3e} (must be 0), eta max "
        f"{float(eta.max()):.5f} m from {eta0.max():.5f} m, "
        f"{cppm.merid_flux.fold_launches - n0} fold flux launches")
    if not (bool(torch.isfinite(eta).all()) and asym == 0.0):
        raise AssertionError(f"fold asymmetry {asym}")
    if not cppm.merid_flux.fold_launches > n0:
        raise AssertionError("the cap launched no fold kernel")


def _flowing(st, G):
    """A 0.5 m/s flow and a T anomaly on thermo_gyre's state: from rest,
    u and v after two cycles sit near the round-off floor of the
    pressure force's column integrals."""
    nz, ny, nx = st.h.shape
    kw = dict(dtype=st.h.dtype, device=st.h.device)
    y, x = torch.linspace(0, 1, ny, **kw), torch.linspace(0, 1, nx, **kw)
    decay = torch.exp(-torch.arange(nz, **kw) / 4.0)[:, None, None]
    return st.replace(
        T=st.T + decay * torch.outer(torch.sin(torch.pi * y),
                                     torch.cos(2 * torch.pi * x)) * G.mask2dT,
        u=0.5 * decay * torch.cos(torch.pi * y)[:, None] * G.mask2dCu,
        v=0.5 * decay * torch.sin(2 * torch.pi * x)[None, :] * G.mask2dCv)


def _small_global(where):
    """The 32x24x5 tripolar global model in float64 on ``where``, as
    (G, GV, state, params, forcing); its mosaic is written beside the
    other outputs of this script."""
    run_dir = os.path.join(OUT, "small_global")
    if not os.path.exists(os.path.join(run_dir, "ocean_hgrid.nc")):
        write_mosaic(run_dir, nx=32, ny_reg=16, ny_cap=8)
    ms = build_model_from_params(
        ParamFile([os.path.join(REPO, "configs", "global_2deg", "MOM_input")],
                  text=SMALL_GLOBAL),
        dtype=torch.float64, device=where, input_dir=run_dir)
    return ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing


def phase_f64(dev):
    """Card (kernels) against CPU (plain versions) in float64: 3 steps of
    the double gyre, 2 thermo cycles of thermo_gyre, 1 thermo cycle of the
    small tripolar global model (T, S, u and v where the layer or face
    holds water)."""
    for name, build, advance, fields in (
            ("double_gyre 24x22x2, 3 steps",
             lambda d: double_gyre(nx=24, ny=22, nz=2, dtype=torch.float64,
                                   device=d),
             lambda st, G, GV, p, f: step_dynamics_split_rk2(st, f, G, GV, p),
             ("h", "u", "v")),
            ("thermo_gyre 16x14x6 from a flowing state, 2 cycles",
             lambda d: thermo_gyre(16, 14, 6, dtype=torch.float64, device=d),
             lambda st, G, GV, p, f: step_mom(st, f, G, GV, p),
             ("h", "u", "v", "T", "S")),
            ("global 32x24x5 (fold, land, GM, KHTR) from a flowing state, "
             "1 cycle", _small_global,
             lambda st, G, GV, p, f: step_mom(st, f, G, GV, p),
             ("h", "u", "v", "T", "S"))):
        out = {}
        n_fold = cppm.merid_flux.fold_launches
        for where in ("cpu", dev):
            G, GV, st, p, f = build(where)
            n = 3
            if "thermo" in name:
                st, n = _flowing(st, G), 2
            elif "global" in name:
                st, n = _flowing(st, G), 1
            with torch.inference_mode():
                for _ in range(n):
                    st = advance(st, G, GV, p, f)
            out[str(where)] = st
        ref, got = out["cpu"], out[str(dev)]
        # T and S in layers that hold water and u and v on faces that do:
        # in a vanished layer (1e-10 m over topography) a velocity is the
        # pressure force's round-off over the face thickness
        h = ref.h
        wet = {"T": h > 1e-3, "S": h > 1e-3,
               "u": 0.5 * (h + ip1(h)) > 1e-3,
               "v": 0.5 * (h + jp1(h, "h" if G.fold_north else None)) > 1e-3}
        errs = {k: rel_err(getattr(got, k).cpu() * wet.get(k, 1),
                           getattr(ref, k) * wet.get(k, 1))
                for k in fields}
        if "global" in name and not cppm.merid_flux.fold_launches > n_fold:
            raise AssertionError("the global cycle launched no fold kernel")
        log(f"[f64] {name}, card vs CPU: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + " (tol 1e-10 relative to max-abs)")
        for k, e in errs.items():
            if not e <= 1e-10:
                raise AssertionError(f"f64 {name} {k}: {e}")
    _f64_new_paths(dev)


def _f64_new_paths(dev):
    """Card against CPU in float64: 2 cycles of the cooled 100-level ePBL
    column of the convection gate (h, u, v, T, S and kv_shear) and 3
    unsplit RK3 steps of a 48x24 soliton (h, u, v); then the kernel
    launches of one ePBL cycle of that column in float32."""
    import torch_gates
    from mom6_tpu_torch.physics.vertical.epbl import epbl_diffusivity
    conv = torch_gates.CONV_BASE + "ENERGETICS_SFC_PBL = True\n"
    cases = (
        ("ePBL column 2x2x100 (cooled 200 W/m2), 2 cycles",
         lambda d: torch_gates.build(d, text=conv, dtype=torch.float64), 2,
         ("h", "u", "v", "T", "S", "kv_shear")),
        ("soliton 48x24x1 (unsplit RK3), 3 steps",
         lambda d: _small_soliton(d, torch.float64), 3, ("h", "u", "v")))
    for name, build, n, fields in cases:
        out = {}
        for where in ("cpu", dev):
            ms = build(where)
            st = ms.state
            with torch.inference_mode():
                for _ in range(n):
                    st = step_mom(st, ms.forcing, ms.grid, ms.vgrid,
                                  ms.params)
            out[str(where)] = st
        ref, got = out["cpu"], out[str(dev)]
        errs = {k: rel_err(getattr(got, k).cpu(), getattr(ref, k))
                for k in fields}
        log(f"[f64] {name}, card vs CPU: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + " (tol 1e-10 relative to max-abs)")
        for k, e in errs.items():
            if not e <= 1e-10:
                raise AssertionError(f"f64 {name} {k}: {e}")
    # what one ePBL cycle costs in launches: the TKE march is a loop over
    # the levels, 3 passes of the MLD feedback
    ms = torch_gates.build(dev, text=conv)
    st, G, GV, f = ms.state, ms.grid, ms.vgrid, ms.forcing
    zero = torch.zeros_like(G.mask2dT)

    def epbl():
        return epbl_diffusivity(st.h, st.T, st.S, G, GV, get_eos("WRIGHT"),
                                zero, zero, f.buoy.heat_flux,
                                cp=ms.params.diabatic.cp,
                                dt=ms.params.dyn.dt * 2)
    one = make_mom_stepper(G, GV, ms.params, f, cycles_per_call=1)
    with torch.inference_mode():
        cyc_ms, cyc_n, _ = _profile(one, st, "epbl_column")
        ep_ms, ep_n, _ = _profile(lambda _: epbl(), st, "epbl_diffusivity")
        epbl()
        torch.cuda.synchronize()
        t0 = time.time()
        epbl()
        torch.cuda.synchronize()
        host = 1e3 * (time.time() - t0)
    log(f"[epbl] the 100-level column in float32: one thermo cycle "
        f"launches {cyc_n} kernels ({cyc_ms:.3f} ms of device time); "
        f"epbl_diffusivity alone {ep_n} kernels, {ep_ms:.3f} ms of device "
        f"time, {host:.3f} ms on the host clock")


def _small_soliton(where, dtype):
    return build_model_from_params(
        ParamFile([os.path.join(REPO, "configs", "soliton", "MOM_input")],
                  text="NIGLOBAL = 48\nNJGLOBAL = 24\n"),
        dtype=dtype, device=where)


def _profile(stepper, st, tag):
    """(device time [ms], kernel launches, ms the host stood blocked on a
    full command buffer) of one call of the stepper, from the profiler's
    device activity (:func:`_device_activity`: the kernels with the
    device's copies and fills); the 40 kernels of most device time go to
    chip_smoke_out/profile_<tag>.txt."""
    dev_ns, n_kern, blocked_ns, by_name = _device_activity(
        lambda: stepper(st))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:40]
    with open(os.path.join(OUT, f"profile_{tag}.txt"), "w") as fh:
        fh.write(f"{n_kern} kernels, {dev_ns / 1e6:.3f} ms of device time\n"
                 "device ms  calls  kernel\n")
        for name, (ns, c) in top:
            fh.write(f"{ns / 1e6:9.3f}  {c:5d}  {name[:160]}\n")
    return dev_ns / 1e6, n_kern, blocked_ns / 1e6


def _check_counts(counts, per, n, what):
    for k, c in counts.items():
        if c != per[k] * n:
            raise AssertionError(f"{what}: {k} launched {c} times, "
                                 f"expected {per[k]} x {n}")


def _dyn_phase_times(G, GV, st, p, f):
    """Device time [ms] of each part of the double gyre's step."""
    h, u, v = st.h, st.u, st.v
    eta = find_eta(h, G)
    h_u, h_v, cu, cv, rem_u, rem_v = _visc_setup(h, u, v, G, GV, p)
    pf = pressure_force_montgomery(h, G, GV)
    _, uh, vh, _, _ = continuity_ppm(u, v, h, p.dt, G, GV)
    z = torch.zeros_like(u)
    bt = p.bt
    parts = {
        "visc_setup (2 tridiag)": lambda: _visc_setup(h, u, v, G, GV, p),
        "continuity_ppm plain call": lambda: continuity_ppm(
            u, v, h, p.dt, G, GV),
        "continuity_ppm matched call": lambda: continuity_ppm(
            u, v, h, p.dt, G, GV, uhbt=uh.sum(0), vhbt=vh.sum(0),
            visc_rem_u=rem_u, visc_rem_v=rem_v),
        "pressure_force": lambda: pressure_force_montgomery(h, G, GV),
        "coriolis_adv": lambda: coriolis_adv(u, v, h, uh, vh, G, GV),
        f"btstep ({bt.nstep}+{bt.nfilter} substeps)": lambda: btstep(
            u, v, eta, z, z, h, uh, vh, rem_u, rem_v, pf.pbce, pf.eta_PF,
            p.dt, G, GV, bt, taux=f.taux, tauy=f.tauy),
        "vertvisc u": lambda: vertvisc(u, h_u, cu, p.dt, tau=f.taux),
        "step": lambda: step_dynamics_split_rk2(st, f, G, GV, p),
    }
    return {k: median_ms(fn, reps=5, warm=1) for k, fn in parts.items()}


def phase_slice(dev):
    """The adiabatic path at 360x280x8 through run_segment, counting
    launches."""
    G, GV, st, p, f = double_gyre(**SLICE, dtype=torch.float32, device=dev)
    log(f"[slice] double_gyre {G.nx}x{G.ny}x{GV.nz} dt={p.dt}: bt nstep "
        f"{p.bt.nstep} nfilter {p.bt.nfilter}")
    s0 = compute_stats(st, G, GV, p.dt)
    reset_kernel_launches()
    torch.cuda.synchronize()
    st1, elapsed = run_segment(st, G, GV, p, f, n_steps=N_STEPS,
                               stats_interval=STATS_INTERVAL, verbose=True)
    counts = kernel_launches()
    log(f"[slice] {N_STEPS} steps in {elapsed:.3f} s with stats: "
        f"{1e3 * elapsed / N_STEPS:.2f} ms/step; launches {counts}")
    _check_counts(counts, PER_STEP, N_STEPS, "double gyre")
    for k in ("h", "u", "v"):
        if not bool(torch.isfinite(getattr(st1, k)).all()):
            raise AssertionError(f"non-finite {k}")
    s1 = compute_stats(st1, G, GV, p.dt)
    drift = abs(s1["mass"] - s0["mass"]) / s0["mass"]
    log(f"[slice] mass drift {drift:.3e} (tol 1e-6), KE {s1['KE']:.6e}, "
        f"h min {float(st1.h.min()):.4e}")
    if not drift < 1e-6:
        raise AssertionError(f"mass drift {drift}")
    if not s1["KE"] > 0.0:
        raise AssertionError("KE is not positive")

    # steady-state step time without the host-side stats
    stepper = make_stepper(G, GV, p, f, steps_per_call=STATS_INTERVAL)
    with torch.inference_mode():
        stepper(st1)
        torch.cuda.synchronize()
        t0 = time.time()
        stepper(st1)
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.time() - t0) / STATS_INTERVAL
        log(f"[slice] step time {ms_step:.3f} ms/step (10 steps, host clock,"
            f" synchronised, no stats)")
        one = make_stepper(G, GV, p, f, steps_per_call=1)
        dev_ms, n_kern, blocked = _profile(one, st1, "double_gyre")
        log(f"[slice] profiler, one step: {n_kern} kernel launches, "
            f"{dev_ms:.3f} ms of device time; device idle "
            f"{100.0 * (1.0 - dev_ms / ms_step):.1f}% of the {ms_step:.3f} "
            f"ms step; host blocked on a full command buffer {blocked:.3f} "
            f"ms")
        for k, ms in _dyn_phase_times(G, GV, st1, p, f).items():
            log(f"[phase] {k}: {ms:.3f} ms")
    return counts


def _thermo_phase_times(G, GV, st, p, f):
    """Device time [ms] of each part of the thermo cycle."""
    eos = get_eos(p.eos_name)
    dt_therm = p.dyn.dt * p.n_dyn_per_thermo

    def pf_fn(h, s):
        return pressure_force_fv(h, s.T, s.S, G, GV, eos,
                                 p_surf=f.mech.p_surf, plm_ts=p.pf_recon)

    def hv_fn(u, v, h):
        return horizontal_viscosity(u, v, h, G, p.hor_visc)

    # T, S and the registered passive tracers, as step_mom stacks them
    names = p.tfc.registry.names if p.tfc is not None else []
    tr = torch.stack([st.T, st.S] + [st.tr[n] for n in names])
    passive = tr[2:] if names else None
    what = ", ".join(["T", "S"] + names)
    uhtr, vhtr = st.uh * dt_therm, st.vh * dt_therm
    parts = {}
    if p.diabatic.boundary_layer_scheme == "KPP":
        # imported here: --tree may name a checkout from before KPP
        from mom6_tpu_torch.core.mom import assemble_diffusivity_extras
        from mom6_tpu_torch.physics.vertical.kpp import kpp_diffusivity
        from mom6_tpu_torch.physics.vertical.shear_mixing import \
            shear_mixing_kd
        zero = torch.zeros_like(G.mask2dT)
        taux = f.mech.taux if f.mech.taux is not None else zero
        tauy = f.mech.tauy if f.mech.tauy is not None else zero
        parts["kpp (kpp_diffusivity)"] = lambda: kpp_diffusivity(
            st.h, st.u, st.v, st.T, st.S, G, GV, eos, taux, tauy,
            f.buoy.heat_flux, cp=p.diabatic.cp)
        shear = "" if p.diabatic.use_shear_mixing else ", not on this path"
        parts[f"shear (shear_mixing_kd, LMD94{shear})"] = lambda: \
            shear_mixing_kd(st.h, st.u, st.v, st.T, st.S, G, GV, eos)
        parts["assemble_diffusivity_extras"] = lambda: \
            assemble_diffusivity_extras(st, f, G, GV, p, eos, dt_therm)
    if p.gm is not None:
        parts["thickness_diffuse (GM, neutral slopes)"] = lambda: \
            thickness_diffuse(st.h, G, GV, dt_therm, p.gm, T=st.T, S=st.S,
                              eos=eos)
    if p.meke is not None and st.E_meke is not None:
        from mom6_tpu_torch.physics.lateral.meke import (gm_pe_release,
                                                         meke_diffusivity,
                                                         step_meke)
        _, uhd, vhd = thickness_diffuse(st.h, G, GV, dt_therm, p.gm, T=st.T,
                                        S=st.S, eos=eos)

        def meke():
            kh = meke_diffusivity(st.E_meke, st.h, G, p.meke)
            src = gm_pe_release(st.h, uhd, vhd, G, GV)
            return kh, step_meke(st.E_meke, src, st.h, G, dt_therm, p.meke)
        parts["meke (diffusivity, GM energy source, step)"] = meke
    if p.khtr > 0.0:
        parts[f"tracer_hordiff ({what}; {p.khtr_n_sub} subcycle)"] = \
            lambda: tracer_hordiff(tr, st.h, p.khtr, dt_therm, G,
                                   n_sub=p.khtr_n_sub)
    if names:
        parts["tracer packages (column_physics)"] = lambda: \
            p.tfc.column_physics(st.tr, st.h, dt_therm, G, GV, T=st.T,
                                 S=st.S, forcing=f)
    parts.update({
        "step_mom (one thermo cycle)": lambda: step_mom(st, f, G, GV, p),
        "step_dynamics_split_rk2 (FV PF, friction)": lambda:
            step_dynamics_split_rk2(st, f.mech, G, GV, p.dyn, pf_fn=pf_fn,
                                    hv_fn=hv_fn, kv_int=st.kv_shear),
        "pressure_force_fv": lambda: pf_fn(st.h, st),
        "horizontal_viscosity": lambda: hv_fn(st.u, st.v, st.h),
        f"advect_tracers ({what}; {p.tracer_advect_sub} sub-sweeps)": lambda:
            advect_tracers(tr, st.h, uhtr, vhtr, G,
                           n_sub=p.tracer_advect_sub),
        f"diabatic_ale ({what}: 1 tridiag)": lambda: diabatic_ale(
            st.T, st.S, st.h, f.buoy, dt_therm, G, GV, p.diabatic,
            extra_tracers=passive),
        "ale_regrid_remap (3 remaps)": lambda: ale_regrid_remap(
            st, G, GV, p.ale, extra_tracers=passive),
    })
    reps = 2 if G.nx * G.ny > 200000 else 5
    return {k: median_ms(fn, reps=reps, warm=1) for k, fn in parts.items()}


def full_physics_setup(nx, ny, nz, dt, n_dyn_per_thermo=2,
                       dtype=torch.float32, device="cuda"):
    """bench.py's _full_physics_setup through the port: thermo_gyre with
    GM (KHTH 100) and MEKE, KHTR 50, the ideal age, KPP and shear mixing,
    with E_meke, the tracers and kv_shear allocated."""
    from mom6_tpu_torch.physics.lateral.meke import MEKEParams
    from mom6_tpu_torch.physics.lateral.thickness_diffuse import GMParams
    from mom6_tpu_torch.tracers.packages import IdealAge, TracerFlowControl
    G, GV, st, p, f = thermo_gyre(nx=nx, ny=ny, nz=nz, len_lon_km=4500.0,
                                  len_lat_km=3500.0, dt=dt,
                                  n_dyn_per_thermo=n_dyn_per_thermo,
                                  dtype=dtype, device=device)
    tfc = TracerFlowControl([IdealAge()])
    p = p.replace(gm=GMParams(khth=100.0), meke=MEKEParams(), khtr=50.0,
                  tfc=tfc, diabatic=dataclasses.replace(
                      p.diabatic, boundary_layer_scheme="KPP",
                      use_shear_mixing=True))
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    st = st.replace(E_meke=z(ny, nx),
                    tr=tfc.init_tracers(tuple(st.h.shape), dtype, device),
                    kv_shear=z(nz + 1, ny, nx))
    return G, GV, st, p, f


def _check_age(tag, st, G, elapsed_s):
    """The ideal age: finite; in the top layer only the trace the remap
    brings up from below after the package zeroes it (below 1% of the
    run); positive below it in wet columns; never older than the run,
    to the float32 round-off of its sums (1e-5 relative: one cycle's
    increment is added in float32 each cycle, and the advection and the
    remap sum over neighbours)."""
    age = st.tr["age"]
    run = elapsed_s / (365.0 * 86400.0)
    wet = G.mask2dT > 0.5
    top = float(age[0].abs().max())
    below = age[1:][:, wet]
    log(f"[{tag}] age after {run:.6e} yr: top layer at most {top:.3e} yr "
        f"(the remap's trace; must be < 1% of the run), below it in "
        f"[{float(below.min()):.6e}, {float(below.max()):.6e}] yr (must be "
        f"> 0 and <= the run x (1 + 1e-5))")
    if not bool(torch.isfinite(age).all()):
        raise AssertionError(f"{tag}: non-finite age")
    if not (top < 0.01 * run and bool((below > 0.0).all())
            and float(age.max()) <= run * (1.0 + 1e-5)):
        raise AssertionError(f"{tag}: age out of bounds")


def phase_full_physics(dev):
    """bench.py's full-physics case through run_segment at 360x280x32 and
    at the OM4 tile, counting launches per thermo cycle; returns the counts
    by path."""
    counts_by = {}
    for tag, (nx, ny, nz, dt, n, every) in FULL_PHYSICS.items():
        G, GV, st, p, f = full_physics_setup(nx, ny, nz, dt, device=dev)
        dt_therm = p.dyn.dt * p.n_dyn_per_thermo
        log(f"[{tag}] bench.py's full-physics case {G.nx}x{G.ny}x{GV.nz} dt="
            f"{p.dyn.dt}, {p.n_dyn_per_thermo} baroclinic steps per thermo "
            f"cycle: bt nstep {p.dyn.bt.nstep} nfilter {p.dyn.bt.nfilter}; "
            f"ALE {p.ale.mode} {p.ale.scheme}, EOS {p.eos_name}, GM KHTH "
            f"{p.gm.khth} with MEKE, KHTR {p.khtr}, boundary layer "
            f"{p.diabatic.boundary_layer_scheme}, shear mixing "
            f"{p.diabatic.use_shear_mixing}, tracers "
            f"{p.tfc.registry.names}")
        s0 = compute_stats(st, G, GV, p.dyn.dt)
        reset_kernel_launches()
        torch.cuda.synchronize()
        st1, elapsed = run_segment(st, G, GV, p, f, n_steps=n,
                                   stats_interval=every, verbose=True)
        counts = kernel_launches()
        log(f"[{tag}] {n} thermo cycles in {elapsed:.3f} s with stats: "
            f"{1e3 * elapsed / n:.2f} ms/cycle; launches {counts}; per "
            f"cycle {({k: c / n for k, c in counts.items()})}")
        _check_counts(counts, PER_CYCLE, n, tag)
        counts_by[tag] = counts
        for k in ("h", "u", "v", "T", "S", "E_meke", "kv_shear"):
            if not bool(torch.isfinite(getattr(st1, k)).all()):
                raise AssertionError(f"{tag}: non-finite {k}")
        s1 = compute_stats(st1, G, GV, p.dyn.dt)
        mass = abs(s1["mass"] - s0["mass"]) / s0["mass"]
        salt = abs(s1["salt"] - s0["salt"]) / s0["salt"]
        flux = float((f.buoy.heat_flux.double() * G.areaT.double()
                      * G.mask2dT.double()).sum()) * dt_therm * n
        log(f"[{tag}] mass drift {mass:.3e} (tol 1e-6), salt drift "
            f"{salt:.3e} (tol 1e-5); heat change "
            f"{s1['heat'] - s0['heat']:.6e} J against the surface heat "
            f"flux's {flux:.6e} J over the run (heat content "
            f"{s0['heat']:.6e} J); KE {s1['KE']:.6e} J, T in "
            f"[{float(st1.T.min()):.4f}, {float(st1.T.max()):.4f}], h min "
            f"{float(st1.h.min()):.4e}, E_meke max "
            f"{float(st1.E_meke.max()):.4e} m2/s2")
        if not mass < 1e-6:
            raise AssertionError(f"{tag}: mass drift {mass}")
        if not salt < 1e-5:
            raise AssertionError(f"{tag}: salt drift {salt}")
        if not s1["KE"] > 0.0:
            raise AssertionError(f"{tag}: KE is not positive")
        _check_age(tag, st1, G, n * dt_therm)
        _check_hbl(st1, G, GV, p, f, tag)

        # steady-state cycle time without the host-side stats
        stepper = make_mom_stepper(G, GV, p, f, cycles_per_call=every)
        with torch.inference_mode():
            stepper(st1)
            torch.cuda.synchronize()
            t0 = time.time()
            stepper(st1)
            torch.cuda.synchronize()
            ms_cycle = 1e3 * (time.time() - t0) / every
            sypd = dt_therm / (ms_cycle / 1e3) / 365.0
            log(f"[{tag}] cycle time {ms_cycle:.3f} ms/thermo cycle ({every} "
                f"cycles, host clock, synchronised, no stats): SYPD "
                f"{sypd:.3f} (simulated years per wall day, "
                f"{p.n_dyn_per_thermo} x {p.dyn.dt} s a cycle)")
            one = make_mom_stepper(G, GV, p, f, cycles_per_call=1)
            dev_ms, n_kern, blocked = _profile(one, st1, tag)
            log(f"[{tag}] profiler, one cycle: {n_kern} kernel launches, "
                f"{dev_ms:.3f} ms of device time; device idle "
                f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}% of the "
                f"{ms_cycle:.3f} ms cycle; host blocked on a full command "
                f"buffer {blocked:.3f} ms")
            if tag == "full_physics":
                for k, ms in _thermo_phase_times(G, GV, st1, p, f).items():
                    log(f"[phase] {k}: {ms:.3f} ms")
        del st, st1, stepper, one
        torch.cuda.empty_cache()
    return counts_by


def build_global(dev):
    """configs/global_half_deg as committed, as a user would build it; the
    720x400 mosaic is generated in memory."""
    t0 = time.time()
    ms = build_model_from_params(
        ParamFile([os.path.join(GLOBAL_DIR, "MOM_input")]), device=dev)
    G, p = ms.grid, ms.params
    wet = G.mask2dT > 0.5
    log(f"[global] built configs/global_half_deg as committed (no reduction) "
        f"in {time.time() - t0:.1f} s: {G.nx}x{G.ny}x{ms.vgrid.nz}"
        f", fold_north {G.fold_north}, cyclic_x {G.cyclic_x}, ocean fraction "
        f"{float(G.mask2dT.mean()):.4f}, smallest wet cell "
        f"{float(G.dxT[wet].min()) / 1e3:.2f} x "
        f"{float(G.dyT[wet].min()) / 1e3:.2f} km; dt {p.dyn.dt}, "
        f"{p.n_dyn_per_thermo} baroclinic steps per thermo cycle, bt nstep "
        f"{p.dyn.bt.nstep} nfilter {p.dyn.bt.nfilter}, "
        f"{p.tracer_advect_sub} advection sub-sweeps, KHTH {p.gm.khth}, KHTR "
        f"{p.khtr} ({p.khtr_n_sub} subcycle), KH {p.hor_visc.kh}, EOS "
        f"{p.eos_name}, ALE {p.ale.mode} {p.ale.scheme}, boundary layer "
        f"{p.diabatic.boundary_layer_scheme}, shear mixing "
        f"{p.diabatic.use_shear_mixing}, restoring "
        f"{ms.forcing.buoy.restore_rate * 86400.0:.2f} m/day")
    if (G.nx, G.ny, ms.vgrid.nz) != GLOBAL_SHAPE[::-1] or not G.fold_north:
        raise AssertionError("not the half-degree tripolar grid")
    if p.diabatic.boundary_layer_scheme != "KPP" or ms.state.kv_shear is None:
        raise AssertionError("the committed global_half_deg runs KPP")
    return ms


def phase_global(dev, ms):
    """The tripolar global path at 720x400x32 through run_segment."""
    G, GV, st, p, f = ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing
    n = N_GLOBAL_CYCLES
    s0 = compute_stats(st, G, GV, p.dyn.dt)
    land = G.mask2dT[None] < 0.5
    wet = G.mask2dT > 0.5
    T_land = (st.T * land).clone()
    one = make_mom_stepper(G, GV, p, f, cycles_per_call=1)
    reset_kernel_launches()
    torch.cuda.synchronize()
    with torch.inference_mode():
        st = one(st)
    # KPP's viscosity after the first cycle, on the top interior interface
    kv = st.kv_shear
    kv1 = kv[1][wet]
    log(f"[global] after the first cycle: kv_shear on the top interior "
        f"interface nonzero in {int((kv1 > 0.0).sum())} of {kv1.numel()} "
        f"wet columns, max {float(kv1.max()):.4e} m2/s")
    if not (bool(torch.isfinite(kv).all()) and float(kv.min()) >= 0.0
            and not kv[0].any() and not kv[-1].any()):
        raise AssertionError("kv_shear is not a boundary-layer viscosity")
    st1, elapsed = run_segment(st, G, GV, p, f, n_steps=n - 1,
                               stats_interval=n - 1, verbose=True)
    counts = kernel_launches()
    log(f"[global] {n} thermo cycles ({n * p.n_dyn_per_thermo} baroclinic "
        f"steps): the last {n - 1} in {elapsed:.3f} s with one stats line: "
        f"{1e3 * elapsed / (n - 1):.2f} ms/cycle; launches {counts}; per "
        f"cycle {({k: c / n for k, c in counts.items()})}")
    _check_counts(counts, PER_GLOBAL_CYCLE, n, "global")
    if not (counts["ppm_edges_y_fold"] > 0 and counts["ppm_flux_y_fold"] > 0):
        raise AssertionError("the global path launched no fold kernel")
    for k in ("h", "u", "v", "T", "S"):
        if not bool(torch.isfinite(getattr(st1, k)).all()):
            raise AssertionError(f"non-finite {k}")
    s1 = compute_stats(st1, G, GV, p.dyn.dt)
    mass = abs(s1["mass"] - s0["mass"]) / s0["mass"]
    wet_T = st1.T[(~land).expand_as(st1.T)]
    t_lo, t_hi = float(wet_T.min()), float(wet_T.max())
    log(f"[global] mass drift {mass:.3e} (tol 1e-6); wet T in [{t_lo:.4f}, "
        f"{t_hi:.4f}] degC (must be inside (-3, 35)); KE {s1['KE']:.6e} J, "
        f"max CFL {s1['max_CFL']:.4f}, max |u| "
        f"{float(st1.u.abs().max()):.4f} m/s, max |v| "
        f"{float(st1.v.abs().max()):.4f} m/s, h min "
        f"{float(st1.h.min()):.4e}")
    if not mass < 1e-6:
        raise AssertionError(f"mass drift {mass}")
    if not (-3.0 < t_lo and t_hi < 35.0):
        raise AssertionError(f"wet T out of range: {t_lo}, {t_hi}")
    if not torch.equal(st1.T * land, T_land):
        raise AssertionError("land columns of T changed")
    if not s1["KE"] > 0.0:
        raise AssertionError("KE is not positive")
    _check_hbl(st1, G, GV, p, f)
    _check_kpp_cycles(dev, ms)

    # steady-state cycle time without the host-side stats
    with torch.inference_mode():
        one(st1)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(2):
            one(st1)
        torch.cuda.synchronize()
        ms_cycle = 1e3 * (time.time() - t0) / 2
        log(f"[global] cycle time {ms_cycle:.3f} ms/thermo cycle (2 cycles, "
            f"host clock, synchronised, no stats); "
            f"{1e3 * elapsed / (n - 1):.3f} ms/cycle with one stats line per "
            f"{n - 1} cycles")
        dev_ms, n_kern, blocked = _profile(one, st1, "global_half_deg")
        log(f"[global] profiler, one cycle: {n_kern} kernel launches, "
            f"{dev_ms:.3f} ms of device time; device idle "
            f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}% of the {ms_cycle:.3f} "
            f"ms cycle; host blocked on a full command buffer {blocked:.3f} "
            f"ms")
        for k, t in _thermo_phase_times(G, GV, st1, p, f).items():
            log(f"[phase] global {k}: {t:.3f} ms")
    return counts


def _check_hbl(st, G, GV, p, f, tag="global"):
    """KPP's boundary-layer depth on the state: finite, and inside
    [min_hbl, column depth] on wet columns."""
    from mom6_tpu_torch.physics.vertical.kpp import (KPPParams,
                                                     kpp_diffusivity)
    with torch.inference_mode():
        _, hbl, _ = kpp_diffusivity(st.h, st.u, st.v, st.T, st.S, G, GV,
                                    get_eos(p.eos_name), f.mech.taux,
                                    f.mech.tauy, f.buoy.heat_flux,
                                    cp=p.diabatic.cp)
    wet = G.mask2dT > 0.5
    hw, col = hbl[wet], st.h.sum(0)[wet]
    lo, hi = float(hw.min()), float(hw.max())
    log(f"[{tag}] boundary-layer depth on wet columns in [{lo:.3f}, "
        f"{hi:.3f}] m, median {float(hw.median()):.3f} m")
    if not bool(torch.isfinite(hbl).all()):
        raise AssertionError("non-finite boundary-layer depth")
    min_hbl = KPPParams().min_hbl
    if not (lo >= min_hbl
            and bool((hw <= torch.clamp(col, min=min_hbl)).all())):
        raise AssertionError(f"boundary-layer depth outside [min_hbl, "
                             f"column depth]: [{lo}, {hi}]")


def _mixed_top(st, G):
    """The state with a mixed top 375 m: in wet columns, T and S of layers
    1 and 2 those of layer 0."""
    wet = G.mask2dT > 0.5
    T, S = st.T.clone(), st.S.clone()
    for k in (1, 2):
        T[k] = torch.where(wet, T[0], T[k])
        S[k] = torch.where(wet, S[0], S[k])
    return st.replace(T=T, S=S)


def _cooled(ms):
    """The built model's initial state with a mixed top, and its forcing
    with a surface cooling of 300 W m-2."""
    G = ms.grid
    f = dataclasses.replace(ms.forcing, buoy=ms.forcing.buoy.replace(
        heat_flux=-300.0 * G.mask2dT))
    return _mixed_top(ms.state, G), f


def _check_kpp_cycles(dev, ms):
    """KPP where it mixes below the top layer, through step_mom.  (The
    committed configurations start from a linear stratification and
    restore SST with no heat flux: their boundary layer stays inside the
    top layer, where the shape function gives no interior diffusivity.)
    From the initial state with a mixed top under a surface cooling of
    300 W m-2, two thermo cycles, so that the second one's vertical
    friction takes the first one's kv_shear:

    * configs/global_half_deg as committed (``ms``: the main path, float32,
      720x400x32) on the card: kv_shear on the top interior interface
      nonzero after the first cycle, the fields finite after the second;
    * configs/global_2deg as committed in float64, each cycle on the card
      from the CPU's state before it against the CPU's cycle (the second
      one takes the CPU's kv_shear; two free cycles part beyond this
      tolerance, PERF.md section 7): h, u, v, T, S and kv_shear within
      1e-10 of their max-abs (T and S where the layer holds water, u and
      v on faces that do)."""
    G, GV, p = ms.grid, ms.vgrid, ms.params
    wet = G.mask2dT > 0.5
    st, f = _cooled(ms)
    with torch.inference_mode():
        st = step_mom(st, f, G, GV, p)
        kv1 = st.kv_shear[1][wet]
        st = step_mom(st, f, G, GV, p)
    log(f"[global] from a 375 m mixed top under 300 W/m2 of cooling "
        f"(float32, 720x400x32): kv_shear on the top interior interface "
        f"after the first cycle nonzero in {int((kv1 > 0).sum())} of "
        f"{kv1.numel()} wet columns, max {float(kv1.max()):.4e} m2/s")
    if not int((kv1 > 0).sum()) > 0:
        raise AssertionError("kv_shear after a cycle under cooling is zero "
                             "on the top interior interface")
    for k in ("h", "u", "v", "T", "S", "kv_shear"):
        if not bool(torch.isfinite(getattr(st, k)).all()):
            raise AssertionError(f"non-finite {k} after two cooled cycles")
    models = {}
    for where in ("cpu", dev):
        m2 = build_model_from_params(ParamFile([os.path.join(
            REPO, "configs", "global_2deg", "MOM_input")]),
            dtype=torch.float64, device=where)
        models[str(where)] = (m2,) + _cooled(m2)
    (mc, st, fc), (md, _, fd) = models["cpu"], models[str(dev)]
    wet2 = mc.grid.mask2dT > 0.5
    t0 = time.time()
    for n in (1, 2):
        with torch.inference_mode():
            ref = step_mom(st, fc, mc.grid, mc.vgrid, mc.params)
            got = step_mom(st.to(dev), fd, md.grid, md.vgrid, md.params)
        h = ref.h
        wet3 = {"T": h > 1e-3, "S": h > 1e-3,
                "u": 0.5 * (h + ip1(h)) > 1e-3,
                "v": 0.5 * (h + jp1(h, "h")) > 1e-3}
        errs = {k: rel_err(getattr(got, k).cpu() * wet3.get(k, 1),
                           getattr(ref, k) * wet3.get(k, 1))
                for k in ("h", "u", "v", "T", "S", "kv_shear")}
        kv = got.kv_shear[1][wet2.to(dev)]
        log(f"[global] global_2deg (float64) from a mixed top under "
            f"cooling, cycle {n} on the card from the CPU's state before "
            f"it, against the CPU's: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol 1e-10 relative to max-abs); kv_shear on the top "
            f"interior interface nonzero in {int((kv > 0).sum())} of "
            f"{kv.numel()} wet columns ({time.time() - t0:.1f} s)")
        for k, e in errs.items():
            if not e <= 1e-10:
                raise AssertionError(f"KPP cycle {n} card vs CPU {k}: {e}")
        if not int((kv > 0).sum()) > 0:
            raise AssertionError("global_2deg: kv_shear under cooling is "
                                 "zero")
        st = ref


def _golden_stats_errors(got, want):
    """Relative differences of the GOLDEN_TOL numbers of two stats."""
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in GOLDEN_TOL
            if k in want}


def phase_golden(dev):
    """The golden configurations in float64, card against CPU: each
    configuration's free run on the card against its free run on the
    CPU, and each cycle on the card from the CPU's state before it
    against the CPU's cycle; every stats number within GOLDEN_TOL.  The
    port divides by numbers with one rounding and sums the layers in
    order on both devices (framework/arith.py), so the two runs are
    expected to agree to the last bits even over vanished layers, where
    a difference in the last bit grows by orders within a few cycles."""
    failed = []
    for name, n in GOLDEN.items():
        pf = os.path.join(REPO, "configs", name, "MOM_input")
        runs = {}
        t0 = time.time()
        for where in ("cpu", dev):
            ms = build_model_from_params(ParamFile([pf]),
                                         dtype=torch.float64, device=where)
            states = [ms.state]
            with torch.inference_mode():
                for _ in range(n):
                    states.append(step_mom(states[-1], ms.forcing, ms.grid,
                                           ms.vgrid, ms.params))
            runs[str(where)] = (ms, states)
        (ms_c, cpu), (ms_d, card) = runs["cpu"], runs[str(dev)]
        for k in ("h", "u", "v", "T", "S", "kv_shear", "E_meke"):
            x = getattr(card[-1], k)
            if x is not None and not bool(torch.isfinite(x).all()):
                raise AssertionError(f"golden {name}: non-finite {k}")
        dt = ms_c.params.dyn.dt

        def stats(st, ms):
            return compute_stats(st, ms.grid, ms.vgrid, dt)

        free = _golden_stats_errors(stats(card[-1], ms_d),
                                    stats(cpu[-1], ms_c))
        cyc = {k: 0.0 for k in free}
        with torch.inference_mode():
            for before, after in zip(cpu[:-1], cpu[1:]):
                st = step_mom(before.to(dev), ms_d.forcing, ms_d.grid,
                              ms_d.vgrid, ms_d.params)
                e = _golden_stats_errors(stats(st, ms_d), stats(after, ms_c))
                cyc = {k: max(cyc[k], e[k]) for k in cyc}
        same = all(torch.equal(getattr(card[-1], k).cpu(),
                               getattr(cpu[-1], k))
                   for k in ("h", "u", "v", "T", "S")
                   if getattr(cpu[-1], k) is not None)

        def fmt(errs):
            return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())

        log(f"[golden] {name} ({ms_c.grid.nx}x{ms_c.grid.ny}x"
            f"{ms_c.vgrid.nz}, {n} cycles, float64), card vs CPU in "
            f"{time.time() - t0:.1f} s: free runs {fmt(free)}; cycle by "
            f"cycle, largest {fmt(cyc)} (tol: mass, heat, salt 1e-12; KE, "
            f"APE 1e-9 relative); the free runs' final h, u, v, T, S "
            f"{'equal' if same else 'not equal'} to the bit")
        for what, errs in (("free run", free), ("cycle by cycle", cyc)):
            for k, e in errs.items():
                if not e <= GOLDEN_TOL[k]:
                    failed.append(f"{name} {what} {k} {e:.3e}")
    if failed:
        raise AssertionError("golden configurations, card vs CPU: "
                             + "; ".join(failed))


def phase_tracer_batch(dev):
    """configs/tracer_batch in float64: each cycle on the card from the
    CPU's state before it against the CPU's cycle, every tracer, h, T and
    S within 1e-10 of max-abs (CFC's exp, log, sqrt and interpolation may
    part by an ulp between the devices); then the asserts of the
    reference's tests/test_tracers.py on the card's last state.  Returns
    the launch counts of the card's cycles."""
    import torch_gates
    from mom6_tpu_torch.diagnostics.sum_output import tracer_stocks
    n = N_TRACER_CYCLES
    t0 = time.time()
    cpu = torch_gates.build("cpu", "tracer_batch", dtype=torch.float64)
    card = torch_gates.build(dev, "tracer_batch", dtype=torch.float64)
    names = card.params.tfc.registry.names
    G = card.grid
    passes = -(-(2 + len(names)) // 4)
    log(f"[tracer_batch] configs/tracer_batch {G.nx}x{G.ny}x{card.vgrid.nz} "
        f"in float64, {len(names)} registered tracers ({names[0]} ... "
        f"{names[-1]}); the cell-field remap takes T, S and the "
        f"{len(names)} as one call of {2 + len(names)} fields, {passes} "
        f"kernel passes of at most 4")
    st_c = cpu.state
    worst = {}
    reset_kernel_launches()
    with torch.inference_mode():
        for c in range(1, n + 1):
            st_d = step_mom(st_c.to(dev), card.forcing, G, card.vgrid,
                            card.params)
            st_c = step_mom(st_c, cpu.forcing, cpu.grid, cpu.vgrid,
                            cpu.params)
            errs = {k: rel_err(getattr(st_d, k).cpu(), getattr(st_c, k))
                    for k in ("h", "T", "S")}
            errs.update({k: rel_err(st_d.tr[k].cpu(), st_c.tr[k])
                         for k in names})
            worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
            bad = {k: e for k, e in errs.items() if not e <= 1e-10}
            if bad:
                raise AssertionError(f"tracer_batch cycle {c}, card vs CPU: "
                                     f"{bad}")
        torch.cuda.synchronize()
    counts = kernel_launches()
    _check_counts(counts, PER_CYCLE, n, "tracer_batch")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    log(f"[tracer_batch] {n} cycles, each on the card from the CPU's state "
        f"before it, in {time.time() - t0:.1f} s: largest differences "
        + ", ".join(f"{k} {e:.3e}" for k, e in top)
        + f" (tol 1e-10 relative to max-abs, all {len(worst)} fields); "
        f"launches {counts}, remap calls per cycle {counts['remap'] / n:g}")
    tr = st_d.tr
    if len(names) != 24 or sum(k.startswith("dye") for k in names) != 20:
        raise AssertionError(f"tracer_batch registers {names}")
    for k in names:
        if not bool(torch.isfinite(tr[k]).all()):
            raise AssertionError(f"tracer_batch: non-finite {k}")
    lo, hi = [], []
    for m in range(20):
        d = tr[f"dye{m + 1:03d}"]
        lo.append(float(d.min()))
        hi.append(float(d.max()))
    stocks = tracer_stocks(tr, st_d.h, G, names=names)
    log(f"[tracer_batch] the card's state after {n} cycles: dyes in "
        f"[{min(lo):.3e}, {max(hi):.6f}], each painted to at least "
        f"{min(hi):.6f}; stocks cfc11 {stocks['cfc11']:.6e}, cfc12 "
        f"{stocks['cfc12']:.6e} mol, age {stocks['age']:.6e} yr m3")
    if not (min(lo) >= -1e-5 and max(hi) <= 1.0 + 1e-5 and min(hi) > 0.99):
        raise AssertionError("tracer_batch: a dye left [0, 1] or was not "
                             "painted")
    if not (stocks["cfc11"] > 0.0 and stocks["cfc12"] > 0.0
            and stocks["age"] > 0.0):
        raise AssertionError(f"tracer_batch: stocks {stocks}")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the open boundaries in this process

def _obc_cycler(ms):
    """(state, cycle index) -> the state a thermo cycle later, with the
    forcing provider's data at the cycle's midpoint where there is one."""
    dt_cycle = ms.params.dyn.dt * ms.params.n_dyn_per_thermo

    def cycle(st, k):
        f = ms.forcing if ms.forcing_provider is None \
            else ms.forcing_provider((k + 0.5) * dt_cycle)
        with torch.inference_mode():
            return step_mom(st, f, ms.grid, ms.vgrid, ms.params)
    return cycle


def _thermo_kind(p):
    """What a thermo cycle of MOMParams ``p`` adds to its launches, as
    ``obc_cycle`` takes it."""
    if not p.thermo_enabled:
        return None
    if p.diabatic.boundary_layer_scheme == "BULKML":
        return "bulkml"
    if p.ale.mode == "LAYER":
        return "layer"
    jhl = p.diabatic.use_shear_mixing and p.diabatic.shear_scheme == "JHL"
    ih4 = p.ale.scheme == "PPM_IH4"
    kinds = [k for k, on in (
        ("ale_pqm", p.ale.scheme == remap.PQM_IH4IH3),
        ("ale_adaptive", p.ale.mode == "ADAPTIVE"),
        ("ale_itides", p.int_tides is not None),
        ("ale" + "_jhl" * jhl + "_ih4" * ih4, jhl or ih4)) if on]
    if len(kinds) > 1 or (p.int_tides is not None
                          and p.int_tides.n_mode != 1):
        raise NotImplementedError(f"obc_cycle counts none of {kinds} "
                                  "together, nor more than one mode")
    return kinds[0] if kinds else "ale"


def phase_obc(dev):
    """The run directories with open boundaries (``[obc]`` lines)."""
    return _run_dirs_phase(dev, OBC_CONFIGS, "obc", ("tc3", "dome"))


def phase_rundirs(dev):
    """The run directories of the sponge, the BBL drag, REENTRANT_Y,
    LF17, the bulk mixed layer and hycom_basin's set (``[rundir]``
    lines)."""
    return _run_dirs_phase(dev, RUNDIR_CONFIGS, "rundir", RUNDIR_CONFIGS)


def _run_dirs_phase(dev, configs, tag, keep):
    """Each run directory of ``configs`` as committed, in float32 on the
    card: one cycle to warm up, then N_OBC_CYCLES cycles with their
    launches held exactly to ``obc_cycle`` and their wall ms per cycle
    (host clock, synchronised), then one cycle under the profiler (device
    time and idle share).  Returns the launches of the runs of ``keep``
    as {tag_name: counts}."""
    out = {}
    for name, cfg in configs.items():
        n_dyn, bt_cont, thermo = cfg[:3]
        n_fields = cfg[3] if len(cfg) > 3 else 2
        ms = build_model_from_params(ParamFile([os.path.join(
            TREE, "configs", name, "MOM_input")]), device=dev)
        p = ms.params
        n_tr = 0 if p.tfc is None else len(p.tfc.registry.names)
        got = (p.n_dyn_per_thermo, p.dyn.bt.use_bt_cont, _thermo_kind(p))
        if got != (n_dyn, bt_cont, thermo) or (
                tag == "obc" and p.obc is None) or (
                "ih4" in str(thermo) and n_fields != 2 + n_tr):
            raise AssertionError(f"{name}: built {got}, obc {p.obc}, "
                                 f"{n_tr} passive tracers")
        cycle = _obc_cycler(ms)
        st = cycle(ms.state, 0)
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.time()
        for k in range(1, N_OBC_CYCLES + 1):
            st = cycle(st, k)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0) / N_OBC_CYCLES
        counts = kernel_launches()
        _check_counts(counts, obc_cycle(n_dyn, bt_cont, thermo, n_fields),
                      N_OBC_CYCLES, name)
        for k in ("h", "u", "v"):
            if not bool(torch.isfinite(getattr(st, k)).all()):
                raise AssertionError(f"{name}: non-finite {k}")
        dev_ms, n_kern, blocked = _profile(
            lambda s: cycle(s, N_OBC_CYCLES + 1), st, f"{tag}_{name}")
        G = ms.grid
        log(f"[{tag}] {name} {G.nx}x{G.ny}x{ms.vgrid.nz} float32, "
            f"{n_dyn} split step(s) a cycle (bt nstep {p.dyn.bt.nstep}), "
            f"BT_cont {bt_cont}, thermo {thermo}: {wall:.2f} wall ms per "
            f"cycle over {N_OBC_CYCLES} cycles (host clock, synchronised); "
            f"profiler, one cycle: {n_kern} kernels, {dev_ms:.3f} ms of "
            f"device time, device idle {100.0 * (1.0 - dev_ms / wall):.1f}%"
            f" of the cycle; host blocked on a full command buffer "
            f"{blocked:.3f} ms; hand-written kernel launches per cycle "
            f"{ {k: v // N_OBC_CYCLES for k, v in counts.items()} }")
        if name in keep:
            out[f"{tag}_{name}"] = counts
    return out


# ---------------------------------------------------------------------------
# phase 15: the modules of spherical_gyre and tides_channel at a size users
# run, one call each, timed

# spherical_gyre's KHTR [m2 s-1], tides_channel's UTIDE [m s-1] and
# INT_TIDE_BACKGROUND_DECAY [s-1]
OPS_KHTR, OPS_UTIDE, OPS_DECAY = 300.0, 0.15, 2.0e-6
N_OPS_CALLS = 10


def _device_split(fn, n=3):
    """(device ms per call of ``fn``, of it in the Thomas kernel, kernels
    per call) from the profiler's device activity over ``n`` calls."""
    dev_ns, n_ev, _, by_name = _device_activity(
        lambda: [fn() for _ in range(n)])
    thomas = sum(ns for k, (ns, _) in by_name.items()
                 if "thomas_kernel" in k)
    return dev_ns / 1e6 / n, thomas / 1e6 / n, n_ev / n


def phase_ops(dev, ms):
    """``[ops]`` lines: one call each of neutral_diffusion (the Redi
    scheme on T, S and 2 seeded passive tracers), build_adaptive_grid,
    wave_speed followed by step_internal_tides (8 angles, the tripolar
    fold) and tidal_mixing_kd on global_half_deg's built float32 state at
    (32, 400, 720): the median ms of N_OPS_CALLS calls from an idle
    device, the device ms, the hand-written kernels' launches and the
    Thomas kernel's share of the device time.  Each result finite."""
    from mom6_tpu_torch.ale.regridding import AdaptParams, \
        build_adaptive_grid
    from mom6_tpu_torch.physics.lateral.internal_tides import (
        InternalTidesParams, init_int_tide_energy, step_internal_tides)
    from mom6_tpu_torch.physics.vertical.tidal_mixing import (
        TidalMixingParams, int_tide_input_tke, tidal_mixing_kd)
    from mom6_tpu_torch.tracers.neutral_diffusion import neutral_diffusion
    G, GV, st, p = ms.grid, ms.vgrid, ms.state, ms.params
    eos = get_eos(p.eos_name)
    dt = p.dyn.dt * p.n_dyn_per_thermo
    rng = np.random.default_rng(13)
    tr = torch.cat([st.T[None], st.S[None], torch.tensor(
        rng.uniform(0.0, 1.0, (2,) + tuple(st.h.shape)),
        dtype=st.h.dtype, device=dev)])
    tmp = TidalMixingParams(utide=OPS_UTIDE)
    itp = InternalTidesParams(n_angle=8, decay_rate=OPS_DECAY)
    with torch.inference_mode():
        tke, _ = int_tide_input_tke(st.h, st.T, st.S, G, GV, eos, tmp)
        en = init_int_tide_energy(itp, G.ny, G.nx, st.h.dtype, dev) \
            + dt * tke[None]
    ops = {
        "neutral_diffusion": lambda: neutral_diffusion(
            tr, st.h, st.T, st.S, G, GV, eos, OPS_KHTR, dt),
        "build_adaptive_grid": lambda: (build_adaptive_grid(
            st.h, st.T, st.S, G, GV, eos, AdaptParams()),),
        "wave_speed + step_internal_tides": lambda: step_internal_tides(
            en, tke, wave_speed(st.h, st.T, st.S, G, GV, eos), G, GV, dt,
            itp),
        "tidal_mixing_kd": lambda: (tidal_mixing_kd(
            st.h, st.T, st.S, G, GV, eos, tmp),),
    }
    for name, fn in ops.items():
        with torch.inference_mode():
            out = fn()
            if not all(bool(torch.isfinite(t).all()) for t in out):
                raise AssertionError(f"[ops] {name}: non-finite result")
            torch.cuda.synchronize()
            reset_kernel_launches()
            fn()
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernel_launches().items() if v}
            wall = median_ms(fn, reps=N_OPS_CALLS, warm=1)
            total, thomas, n_kern = _device_split(fn)
        log(f"[ops] {name} at {tuple(st.h.shape)} float32: median "
            f"{wall:.3f} ms of {N_OPS_CALLS} calls from an idle device, "
            f"{total:.3f} ms of device time in {n_kern:.0f} kernels, "
            f"hand-written launches {launches}, the Thomas kernel "
            f"{thomas:.4f} ms ({100.0 * thomas / max(total, 1e-30):.1f}% "
            f"of the device time)")
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: the coupled entry points, the NUOPC and FMS caps

COUPLED_OUT = os.path.join(OUT, "coupled")
# the coupled options of a global_half_deg run directory: frazil, the
# dynamic surface pressure, SURFBANDS waves (three bands, misalignment),
# the brine plume, the two-band opacity and the NPZD generic tracer
COUPLED_OVERRIDE = """FRAZIL = True
DYNAMIC_SURFACE_PRESSURE = True
USE_WAVES = True
WAVE_METHOD = SURFBANDS
SURFBAND_WAVENUMBERS = 0.04, 0.11, 0.3305
SURFBAND_STOKES_X = 0.05, 0.03, 0.01
SURFBAND_STOKES_Y = 0.0, 0.01, 0.0
LA_MISALIGNMENT = True
DO_BRINE_PLUME = True
PEN_SW_NBANDS = 2
USE_generic_tracer = True
"""
N_NUOPC_INTERVALS, N_FMS_INTERVALS = 4, 2
COUPLED_START = (2000, 1, 1)
# the sea-ice band of the imports: wet cells north of 65 N
ICE_LAT = 65.0
# tests/test_torch_coupled.py's small directory (12x10x4), every coupled
# option on, for the card against the CPU in float64
N_SMALL_INTERVALS = 2
COUPLED_TOL = 1e-10
# the NPZD tracers widen the diabatic solve to T, S and 4 (coefficients
# shared) and the cell fields' remap to nf = 6 at (32, 400, 720)
COUPLED_SHARED = (6,) + GLOBAL_SHAPE
COUPLED_REMAP = (6,) + GLOBAL_SHAPE


def _coupled_dir(where, base_text, override=None):
    """A fresh run directory ``where`` with ``base_text`` as its MOM_input
    and ``override`` as its MOM_override."""
    shutil.rmtree(where, ignore_errors=True)
    os.makedirs(where)
    with open(os.path.join(where, "MOM_input"), "w") as fh:
        fh.write(base_text)
    if override:
        with open(os.path.join(where, "MOM_override"), "w") as fh:
            fh.write(override)
    return where


def _coupled_imports(G, k, lamult, device, dtype=torch.float32, seed=41):
    """The NUOPC imports of interval ``k``: the full flux set of
    tests/test_nuopc_cap.py::_imports with seeded variations, 3-band
    Sw_pstokes_x/y, Si_ifrac and Fioi_salt over the ice band,
    Faxa_ndep, Sa_co2prog and, with ``lamult``, Sw_lamult; made on
    ``device`` from a seeded generator on the CPU."""
    g = torch.Generator().manual_seed(seed + k)
    ny, nx = G.ny, G.nx

    def f(mean, amp, shape=(ny, nx)):
        r = 2.0 * torch.rand(shape, generator=g, dtype=torch.float64) - 1.0
        return (mean + amp * r).to(device=device, dtype=dtype)
    band = ((G.geoLatT >= ICE_LAT) & (G.mask2dT > 0.5)).to(dtype)
    d = {"Foxx_taux": f(0.05, 0.02), "Foxx_tauy": f(0.0, 0.02),
         "Foxx_sen": f(-15.0, 5.0), "Foxx_evap": f(-2e-5, 1e-5),
         "Foxx_lwnet": f(-60.0, 5.0), "Foxx_swnet_vdr": f(60.0, 10.0),
         "Foxx_swnet_vdf": f(40.0, 5.0), "Foxx_swnet_idr": f(50.0, 5.0),
         "Foxx_swnet_idf": f(30.0, 5.0), "Faxa_rain": f(3e-5, 1e-5),
         "Faxa_snow": f(1e-6, 5e-7), "Foxx_rofl": f(1e-6, 5e-7),
         "Foxx_rofi": f(1e-7, 5e-8), "Fioi_salt": band * f(3e-6, 1e-6),
         "Fioi_meltw": f(1e-6, 5e-7), "Fioi_melth": f(-5.0, 2.0),
         "Foxx_hrain": f(0.5, 0.1), "Foxx_hsnow": f(-0.1, 0.05),
         "Foxx_hevap": f(-0.4, 0.1), "Foxx_hcond": f(0.1, 0.05),
         "Foxx_hrofl": f(0.2, 0.05), "Foxx_hrofi": f(-0.05, 0.01),
         "Sa_pslv": f(101325.0, 100.0), "Si_ifrac": band * f(0.8, 0.2),
         "So_duu10n": f(49.0, 10.0),
         "Sw_pstokes_x": f(0.05, 0.02, (3, ny, nx)),
         "Sw_pstokes_y": f(0.01, 0.01, (3, ny, nx)),
         "Faxa_ndep": f(1e-4, 5e-5), "Sa_co2prog": f(400.0, 10.0)}
    if lamult:
        d["Sw_lamult"] = f(1.5, 0.3)
    return d


def _coupled_iob(G, k, device, dtype=torch.float32, seed=43):
    """The FMS exchange of interval ``k``: wind, heat, water and pressure,
    and the ice's mass and rigidity over the ice band."""
    from mom6_tpu_torch.drivers.coupled_cap import IceOceanBoundary
    g = torch.Generator().manual_seed(seed + k)

    def f(mean, amp):
        r = 2.0 * torch.rand((G.ny, G.nx), generator=g,
                             dtype=torch.float64) - 1.0
        return (mean + amp * r).to(device=device, dtype=dtype)
    band = ((G.geoLatT >= ICE_LAT) & (G.mask2dT > 0.5)).to(dtype)
    return IceOceanBoundary(
        u_flux=f(0.08, 0.02), v_flux=f(-0.02, 0.02), t_flux=f(20.0, 5.0),
        q_flux=f(2e-5, 1e-5), lw_flux=f(50.0, 5.0), sw_flux=f(150.0, 30.0),
        lprec=f(2e-5, 1e-5), fprec=f(1e-6, 5e-7), runoff=f(1e-6, 5e-7),
        p=f(101325.0, 200.0), salt_flux=band * f(2e-6, 1e-6),
        u10_sqr=f(64.0, 10.0), mi=band * f(900.0, 100.0),
        ice_rigidity=band * f(1e10, 5e9))


def _equal_nan(a, b):
    """Bitwise equal, a NaN equal to a NaN at the same place."""
    na, nb = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.equal(na, nb) and torch.equal(torch.where(na, zero, a),
                                               torch.where(nb, zero, b))


def _content(st, G, names):
    """Sum of the state's ``names`` tracers times h times the cell area,
    float64 (h alone for "h")."""
    area = (G.areaT * G.mask2dT).double()
    total = 0.0
    for n in names:
        c = st.h.double() if n == "h" else st.h.double() * st.tr[n].double()
        total += float((c * area).sum())
    return total


def _check_coupled_kernels(cap, run):
    """``run()``, a coupling interval of ``cap``'s model, with its
    diabatic solve and the cell fields' remap captured: each, float32 as
    captured and float64, kernel against plain bitwise; returns what
    ``run`` returned."""
    from mom6_tpu_torch.ale import ale as ale_mod
    from mom6_tpu_torch.tracers import vert_diff
    seen_remap, out = [], []
    orig = ale_mod.remap_columns_multi

    def record(fields, h0, h1, scheme=remap.PPM_H4):
        seen_remap.append((fields, h0, h1, scheme))
        return orig(fields, h0, h1, scheme)
    ale_mod.remap_columns_multi = record
    try:
        seen = _captured_solves(vert_diff, lambda: out.append(run()))
    finally:
        ale_mod.remap_columns_multi = orig
    if len(seen) != 1 or len(seen_remap) != 1:
        raise AssertionError(f"[coupled] {len(seen)} diabatic solves, "
                             f"{len(seen_remap)} cell-field remaps a cycle")
    (a, b, c, d), (f, h0, h1, scheme) = seen[0], seen_remap[0]
    # the remap is held on every column, land included, a NaN equal to a
    # NaN (none is left on land since the brine plume's repair)
    for dtype in (torch.float32, torch.float64):
        x_k = solvers.tridiag_solve(*(t.to(dtype) for t in (a, b, c, d)))
        x_p = solvers.tridiag_solve_plain(*(t.to(dtype) for t in (a, b, c,
                                                                  d)))
        fd, h0d, h1d = (t.to(dtype) for t in (f, h0, h1))
        r_k = remap.remap_columns_multi(fd, h0d, h1d, scheme)
        coef, lo, hi = remap.remap_coefficients(fd, h0d, scheme)
        r_p = remap.remap_integrals_plain(coef, h0d, h1d, lo, hi)
        torch.cuda.synchronize()
        if not (torch.equal(x_k, x_p) and _equal_nan(r_k, r_p)):
            raise AssertionError(
                f"[coupled] captured kernels {dtype}: tridiag "
                f"{float((x_k - x_p).abs().max())}, remap "
                f"{float((r_k - r_p).abs().nan_to_num(0.0).max())}, NaN "
                f"{int(r_k.isnan().sum())} / {int(r_p.isnan().sum())}")
    shared = (d.shape[1], d.shape[0]) + tuple(d.shape[2:])
    log(f"[coupled] captured from the cycle: the diabatic solve of T, S and "
        f"the NPZD tracers, coefficients {tuple(a.shape)} shared by the "
        f"right-hand sides of {tuple(d.shape)} (phase 3's {shared}); the "
        f"cell fields' remap nf={f.shape[0]} {tuple(f.shape)} ({scheme}); "
        f"each float32 and float64 bitwise equal to the plain version (the "
        f"remap on every column, land included; a NaN would count equal to "
        f"a NaN, and the captured fields hold "
        f"{int((~torch.isfinite(f)).sum())} non-finite values)")
    if shared != COUPLED_SHARED or tuple(f.shape) != COUPLED_REMAP:
        raise AssertionError(f"[coupled] captured {shared}, "
                             f"{tuple(f.shape)}: phase 3 checks "
                             f"{COUPLED_SHARED}, {COUPLED_REMAP}")
    return out[0]


def _coupled_small(dev):
    """The NUOPC lifecycle on the small directory in float64, the card
    against the CPU: N_SMALL_INTERVALS intervals under the same imports,
    every export and the dated restart's fields within COUPLED_TOL of
    max-abs."""
    import torch_gates
    from mom6_tpu_torch.drivers.nuopc import NUOPCCap
    from mom6_tpu_torch.io.netcdf import read_nc
    text = torch_gates.CAP_BASE + "USE_KPP = True\n" + COUPLED_OVERRIDE
    runs = {}
    for device in (dev, "cpu"):
        d = _coupled_dir(os.path.join(COUPLED_OUT, f"small_{device}"), text)
        cap = NUOPCCap(d, device=device, dtype=torch.float64)
        cap.advertise()
        cap.realize(stop_days=1.0, restart_interval_sec=int(
            N_SMALL_INTERVALS * 1800), start_date=COUPLED_START)
        exports = []
        for k in range(N_SMALL_INTERVALS):
            imp = _coupled_imports(cap.model.grid, k,
                                   k == N_SMALL_INTERVALS - 1, device,
                                   torch.float64)
            exports.append({n: v.cpu() for n, v in cap.advance(imp).items()})
        (name,) = os.listdir(cap.restart_dir)
        runs[device] = (exports, read_nc(os.path.join(cap.restart_dir,
                                                      name)))
    worst = {}
    for k, (e_card, e_cpu) in enumerate(zip(runs[dev][0], runs["cpu"][0])):
        for n in e_cpu:
            worst[f"{n}[{k}]"] = rel_err(e_card[n], e_cpu[n])
    r_card, r_cpu = runs[dev][1], runs["cpu"][1]
    if set(r_card) != set(r_cpu):
        raise AssertionError("[coupled] the restarts hold other fields")
    for n in r_cpu:
        worst["restart " + n] = rel_err(
            *(torch.tensor(np.asarray(r[n], np.float64)) for r in (r_card,
                                                                   r_cpu)))
    top = max(worst, key=worst.get)
    log(f"[coupled] card against CPU, float64, the 12x10x4 directory with "
        f"every coupled option, {N_SMALL_INTERVALS} NUOPC intervals: "
        f"{len(worst)} exports and restart fields, largest {worst[top]:.3e} "
        f"of max-abs ({top}; tol {COUPLED_TOL})")
    if not worst[top] <= COUPLED_TOL:
        raise AssertionError(f"[coupled] card against CPU {top}: "
                             f"{worst[top]}")


def phase_coupled(dev):
    """``[coupled]`` lines: configs/global_half_deg with COUPLED_OVERRIDE
    through the NUOPC cap, float32 at 720x400x32: advertise, realize with
    a restart alarm ringing once, N_NUOPC_INTERVALS intervals of imports
    (Sw_lamult in the last), then N_FMS_INTERVALS of update_ocean_model
    with the ice's mass and rigidity.  Every export finite, the mass drift
    under 1e-6, the NPZD nitrogen conserved apart from the deposition, the
    dated restart written with every field; the wall ms a coupling
    interval, the launches (exactly ``fold_cycle(6)`` an interval), the
    device's idle share of a profiled interval; the kernels at the shapes
    captured from the cycle; then the small directory card against CPU.
    Returns the launches of the driven intervals."""
    from mom6_tpu_torch.drivers.coupled_cap import (convert_iob_to_forcing,
                                                    update_ocean_model)
    from mom6_tpu_torch.drivers.nuopc import FLDS_FR_OCN, NUOPCCap
    d = _solo_dir("global_half_deg", "coupled", COUPLED_OVERRIDE)
    t0 = time.time()
    cap = NUOPCCap(d, device=dev)
    cap.advertise()
    pf = ParamFile([os.path.join(d, "MOM_input")])
    dt_cpl = pf.get("DT_THERM", float)
    cap.realize(stop_days=1.0,
                restart_interval_sec=int(N_NUOPC_INTERVALS * dt_cpl),
                calendar="NOLEAP", start_date=COUPLED_START)
    model = cap.model
    G, GV, p = model.grid, model.vgrid, model.params
    torch.cuda.synchronize()
    names = p.tfc.registry.names if p.tfc is not None else []
    log(f"[coupled] NUOPCCap realized on configs/global_half_deg + "
        f"MOM_override in {time.time() - t0:.1f} s: {G.nx}x{G.ny}x{GV.nz} "
        f"float32, coupling interval {model.coupling_dt:.0f} s "
        f"({p.n_dyn_per_thermo} steps), KPP "
        f"{p.diabatic.boundary_layer_scheme == 'KPP'}, waves "
        f"{p.waves.method} ({len(p.waves.band_wavenumbers)} bands, "
        f"misalignment {p.waves.misalignment}), dynamic surface pressure "
        f"{p.dyn.bt.dynamic_psurf}, brine plume {p.diabatic.do_brine_plume}, "
        f"opacity {p.diabatic.opacity is not None}, frazil "
        f"{p.diabatic.frazil}, packages {names}")
    if not (p.dyn.bt.dynamic_psurf and p.diabatic.do_brine_plume
            and p.diabatic.opacity is not None and p.diabatic.frazil
            and p.waves.method == "SURFBANDS" and p.waves.misalignment
            and names == ["no3", "phy", "zoo", "det"] and G.fold_north
            and p.diabatic.boundary_layer_scheme == "KPP"):
        raise AssertionError("[coupled] not every coupled option is on")
    st0 = model.state
    mass0 = _content(st0, G, ["h"])
    n0 = _content(st0, G, names)
    area = (G.areaT * G.mask2dT).double()
    deposited = 0.0
    per = fold_cycle(p.n_dyn_per_thermo)
    walls = []
    reset_kernel_launches()
    counts = None
    for k in range(N_NUOPC_INTERVALS + N_FMS_INTERVALS):
        before = kernel_launches()
        torch.cuda.synchronize()
        t1 = time.time()
        if k < N_NUOPC_INTERVALS:
            imp = _coupled_imports(G, k, k == N_NUOPC_INTERVALS - 1, dev)
            exp = cap.advance(imp)
            deposited += model.coupling_dt * float(
                (imp["Faxa_ndep"].double() * area).sum())
        else:
            iob = _coupled_iob(G, k, dev)
            sfc = update_ocean_model(model, iob)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.time() - t1))
        got = {n: c - before[n] for n, c in kernel_launches().items()}
        if got != per:
            raise AssertionError(f"[coupled] interval {k}: launches {got}, "
                                 f"expected {per}")
        if k < N_NUOPC_INTERVALS:
            if set(exp) != set(FLDS_FR_OCN):
                raise AssertionError(f"[coupled] exports {sorted(exp)}")
            bad = [n for n, v in exp.items()
                   if not bool(torch.isfinite(v).all())]
            if bad:
                raise AssertionError(f"[coupled] non-finite exports {bad}")
        else:
            bad = [n for n, v in sfc._asdict().items() if v is not None
                   and not bool(torch.isfinite(v).all())]
            if bad:
                raise AssertionError(f"[coupled] non-finite surface {bad}")
    counts = kernel_launches()
    st = model.state
    for n in ("h", "u", "v", "T", "S"):
        if not bool(torch.isfinite(getattr(st, n)).all()):
            raise AssertionError(f"[coupled] non-finite {n}")
    mass = abs(_content(st, G, ["h"]) - mass0) / mass0
    n1 = _content(st, G, names)
    n_err = abs(n1 - n0 - deposited) / n0
    files = sorted(os.listdir(cap.restart_dir))
    want = "mom.r.{:04d}-{:02d}-{:02d}-{:05d}.nc".format(
        *COUPLED_START, int(N_NUOPC_INTERVALS * dt_cpl))
    from mom6_tpu_torch.io.netcdf import read_nc
    held = set(read_nc(os.path.join(cap.restart_dir, want))) \
        if want in files else set()
    wet = G.mask2dT > 0.5
    q = exp["Fioo_q"][wet]
    log(f"[coupled] {N_NUOPC_INTERVALS} NUOPC and {N_FMS_INTERVALS} FMS "
        f"intervals: wall ms an interval {[round(w, 2) for w in walls]} "
        f"(host clock, synchronised; the first builds the kernels' caches), "
        f"launches an interval {per} (exactly fold_cycle("
        f"{p.n_dyn_per_thermo})); mass drift {mass:.3e} (tol 1e-6); NPZD "
        f"nitrogen {n0:.6e} -> {n1:.6e} mmol, deposited {deposited:.6e}, "
        f"budget error {n_err:.3e} of the total (tol 1e-5); the last "
        f"export's Fioo_q in [{float(q.min()):.4g}, {float(q.max()):.4g}] "
        f"W m-2, So_dhdy max {float(exp['So_dhdy'].abs().max()):.4e}; "
        f"restart files {files} holding {sorted(held)}")
    if not mass < 1e-6:
        raise AssertionError(f"[coupled] mass drift {mass}")
    if not n_err < 1e-5:
        raise AssertionError(f"[coupled] nitrogen budget error {n_err}")
    if files != [want] or not {"frazil", "tr_no3", "tr_det", "h", "T"} <= held:
        raise AssertionError(f"[coupled] restart {files}, {sorted(held)}")
    # one more interval under the profiler (its state is not kept)
    iob = _coupled_iob(G, N_NUOPC_INTERVALS + N_FMS_INTERVALS, dev)
    from mom6_tpu_torch.diagnostics.diagnostics import extract_surface_state
    forcing = convert_iob_to_forcing(iob, extract_surface_state(
        st, G, GV).sss, GV)
    wall = statistics.median(walls[1:])
    dev_ms, n_kern, blocked = _check_coupled_kernels(cap, lambda: _profile(
        lambda s: model._step(s, forcing), st, "coupled"))
    log(f"[coupled] profiler, one FMS interval: {n_kern} kernels, "
        f"{dev_ms:.3f} ms of device time; device idle "
        f"{100.0 * (1.0 - dev_ms / wall):.1f}% of the median {wall:.2f} wall "
        f"ms an interval; host blocked on a full command buffer "
        f"{blocked:.3f} ms")
    del cap, model, st, st0
    torch.cuda.empty_cache()
    _coupled_small(dev)
    return counts


# ---------------------------------------------------------------------------
# phase 17: the step's shared options through the CLI (tests/torch_gates.py
# ::OPTIONS_OVERRIDE on configs/global_half_deg)

# two thermo cycles of the options through the CLI (half a day, 6 cycles,
# until the RK2b and ODA phases joined the script's 1200 s)
OPTIONS_DAYS = 2 * 7200.0 / 86400.0
# the orderings, one cycle each in this process from the CLI's restart
OPTION_ORDERINGS = ({"diabatic_first": True}, {"homogenize_forcings": True})
# tests/test_torch_options.py's small directory, card against CPU in float64
OPTIONS_SMALL = ("NIGLOBAL = 12\nNJGLOBAL = 10\nNK = 6\nKHTR = 300.0\n")
N_SMALL_OPTION_CYCLES = 3
OPTIONS_TOL = 1e-10


def _options_on(p, G):
    return (p.dyn.bt.lin_drag > 0.0 and p.dyn.bt.cdrag > 0.0
            and p.dyn.kappa_gl90 > 0.0 and p.khtr_passivity_coeff > 0.0
            and p.khtr_max > 0.0 and p.khtr_bl > 0.0
            and p.diabatic.convection is not None
            and p.diabatic.ddiff is not None and G.fold_north
            and p.diabatic.boundary_layer_scheme == "KPP")


def _check_split_solve(seen, shape):
    """The captured diabatic solve: per-tracer coefficients of ``shape``
    (nz, n_tr, ny, nx), float32 as captured and float64, kernel against
    plain bitwise."""
    if len(seen) != 1:
        raise AssertionError(f"[options] {len(seen)} diabatic solves a cycle")
    a, b, c, d = seen[0]
    if tuple(a.shape) != tuple(d.shape) or tuple(a.shape) != shape:
        raise AssertionError(f"[options] captured a {tuple(a.shape)}, d "
                             f"{tuple(d.shape)}: expected {shape}")
    for dtype in (torch.float32, torch.float64):
        args = [t.to(dtype) for t in (a, b, c, d)]
        x_k = solvers.tridiag_solve(*args)
        x_p = solvers.tridiag_solve_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(x_k, x_p):
            raise AssertionError(f"[options] captured split solve {dtype}: "
                                 f"{float((x_k - x_p).abs().max())}")
    return (d.shape[1], d.shape[0]) + tuple(d.shape[2:])


def _small_card_vs_cpu(dev, tag, what, override, runs, fields):
    """tests/test_torch_options.py's and tests/test_torch_lateral.py's
    directory (12x10x6 configs/benchmark, OPTIONS_SMALL) with ``override``
    (``what`` names it) in float64, the card against the CPU one cycle at
    a time from the CPU's state: one cycle for each (change of the
    parameters, label) of ``runs``; the ``fields`` everywhere, and T and
    S where the layer, u and v where the face holds more than 1 mm of
    water, within OPTIONS_TOL of max-abs."""
    pf = lambda: ParamFile([os.path.join(TREE, "configs", "benchmark",
                                         "MOM_input")],
                           text=OPTIONS_SMALL + override)
    ms = {w: build_model_from_params(pf(), dtype=torch.float64, device=w)
          for w in (dev, "cpu")}
    st = ms["cpu"].state
    worst = {}
    with torch.inference_mode():
        for k, (change, label) in enumerate(runs):
            out = {}
            for w in (dev, "cpu"):
                m = ms[w]
                out[w] = step_mom(st.to(m.grid.mask2dT.device), m.forcing,
                                  m.grid, m.vgrid, change(m.params))
            h = out["cpu"].h
            wet = dict({n: None for n in fields}, T=h > 1e-3, S=h > 1e-3,
                       u=0.5 * (h + ip1(h)) > 1e-3,
                       v=0.5 * (h + jp1(h)) > 1e-3)
            for n, where in wet.items():
                a, b = getattr(out[dev], n).cpu(), getattr(out["cpu"], n)
                if where is not None:
                    a, b = a[where], b[where]
                worst[f"{n}[{k} {label}]"] = rel_err(a, b)
            st = out["cpu"]
    top = max(worst, key=worst.get)
    labels = [label for _, label in runs]
    log(f"[{tag}] card against CPU, float64, the 12x10x6 directory with "
        f"{what}, one cycle at a time from the CPU's state, with "
        f"{labels}: largest {worst[top]:.3e} of max-abs ({top}; tol "
        f"{OPTIONS_TOL})")
    if not worst[top] <= OPTIONS_TOL:
        raise AssertionError(f"[{tag}] card against CPU {top}: "
                             f"{worst[top]}")


def _options_small(dev):
    """The options' directory card against CPU (:func:`_small_card_vs_cpu`):
    N_SMALL_OPTION_CYCLES cycles, then one with DIABATIC_FIRST (and the
    Redi scheme, whose K S^2 part then takes a solve of its own) and one
    with HOMOGENIZE_FORCINGS."""
    import torch_gates
    runs = [(lambda p: p, "options")] * N_SMALL_OPTION_CYCLES + [
        (lambda p: p.replace(diabatic_first=True, neutral_diffusion=True),
         "diabatic_first"),
        (lambda p: p.replace(homogenize_forcings=True),
         "homogenize_forcings")]
    _small_card_vs_cpu(dev, "options", "the options",
                       torch_gates.OPTIONS_OVERRIDE, runs,
                       ("h", "T", "S", "u", "v"))


def _cli_phase(dev, tag, override, days, on, options, card, prepare=None,
               build_launches=None, in_build=None, per_cycle=fold_cycle):
    """configs/global_half_deg with ``override`` through the CLI for
    ``days``, float32 at 720x400x32: ocean.stats finite, mass drift under
    1e-6 and salt drift under 1e-5 of the totals, the launches exactly
    ``per_cycle(6)`` a cycle, the wall ms a cycle (``options(p)`` names
    the options on the line, ``on(p, G)`` says that each is on); then
    the model built in this process from the same files and the CLI's
    restart restored.  ``prepare(d)`` writes what the run directory
    needs before the CLI starts; ``build_launches`` are the launches the
    build makes, which the CLI counts with the cycles'; ``in_build(run)``
    wraps the build in this process.  Returns (ModelSetup, the restored
    state, its time [s], the build's seconds, the launches a cycle, the
    CLI's launches)."""
    from mom6_tpu_torch.framework.restart import RestartRegistry
    d = _solo_dir("global_half_deg", tag, override)
    if prepare is not None:
        prepare(d)
    secs = _run_solo([(d, ["--days", repr(days)])], 1)[d]
    built = []

    def build():
        built.append(build_model_from_params(ParamFile(
            [os.path.join(d, "MOM_input"), os.path.join(d, "MOM_override")]),
            device=dev))
    t0 = time.time()
    (in_build or (lambda run: run()))(build)
    t_build = time.time() - t0
    ms = built[0]
    p = ms.params
    if not on(p, ms.grid):
        raise AssertionError(f"[{tag}] not every option is on")
    n = int(round(days * 86400.0 / (p.dyn.dt * p.n_dyn_per_thermo)))
    per = per_cycle(p.n_dyn_per_thermo)
    lines = _solo_stats(d)
    wall, sypd, timers, launches = _solo_cputime(d)
    s = lines[-1]
    mass = abs(s["dM_net"]) / s["Mass"]
    salt = abs(s["dS_net"]) / s["Salt"]
    log(f"[{tag}] python -m mom6_tpu_torch.drivers.solo global_half_deg "
        f"--days {days!r} with {options(p)}: {n} thermo cycles, "
        f"{len(lines)} ocean.stats line(s), process {secs:.1f} s; "
        f"ocean.cputime: wall {wall:.2f} s, SYPD {sypd:.2f}, "
        f"{1e3 * wall / n:.1f} wall ms per cycle "
        f"({1e3 * timers.get('ocean dynamics+thermo', 0.0) / n:.1f} ms "
        f"stepping); launches {launches} (exactly {per_cycle.__name__}("
        f"{p.n_dyn_per_thermo}) x {n}); mass drift {mass:.3e} (tol 1e-6), "
        f"salt drift {salt:.3e} (tol 1e-5); {card}")
    if not all(math.isfinite(v) for v in s.values()):
        raise AssertionError(f"[{tag}] ocean.stats not finite: {s}")
    if not (mass < 1e-6 and salt < 1e-5):
        raise AssertionError(f"[{tag}] drift: mass {mass}, salt {salt}")
    extra = build_launches or {}
    _check_counts({k: c - extra.get(k, 0) for k, c in launches.items()},
                  per, n, tag)
    reg = RestartRegistry()
    reg.register_state(ms.state)
    st, t_s, _ = reg.restore_state(os.path.join(d, "MOM.res.nc"), ms.state)
    return ms, st, t_s, t_build, per, launches


def _timed_cycle(cycle, st):
    """Wall ms of one call of ``cycle(st)`` (host clock, synchronised)."""
    torch.cuda.synchronize()
    t1 = time.time()
    cycle(st)
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t1)


def _contents(x, area):
    """The heat (T h) and salt (S h) contents of ``x``, float64."""
    h = x.h.double() * area
    return (float((x.T.double() * h).sum()), float((x.S.double() * h).sum()))


def _variant_cycle(tag, cycle, st, G, label, per, fields, card, base=None):
    """One cycle ``cycle(st)`` of a variant: its wall ms, its launches
    held to ``per``, its ``fields`` finite, its volume kept to 1e-6; with
    ``base``, the base configuration's state one cycle from ``st``, its
    heat and salt contents held to the base's to 1e-6 of the totals (the
    same forcing acted on both)."""
    wet = G.mask2dT > 0.5
    area = (G.areaT * G.mask2dT).double()
    v0 = float((st.h.double() * area).sum())
    before = kernel_launches()
    torch.cuda.synchronize()
    t1 = time.time()
    out = cycle(st)
    torch.cuda.synchronize()
    wall_k = 1e3 * (time.time() - t1)
    got = {k: c - before[k] for k, c in kernel_launches().items()}
    bad = [k for k in fields if not bool(torch.isfinite(getattr(out, k))
                                         .all())]
    drift = abs(float((out.h.double() * area).sum()) - v0) / v0
    t_w = out.T[wet.expand_as(out.T)]
    against = [0.0, 0.0]
    if base is not None:
        c0 = _contents(st, area)
        against = [abs(a - b) / abs(c) for a, b, c in
                   zip(_contents(out, area), _contents(base, area), c0)]
    log(f"[{tag}] one cycle with {label}: {wall_k:.2f} wall ms, launches "
        f"{got}, mass drift {drift:.3e}, wet T in [{float(t_w.min()):.4f}, "
        f"{float(t_w.max()):.4f}] degC, max |u| "
        f"{float(out.u.abs().max()):.4f} m/s"
        + ("" if base is None else
           f", heat and salt contents against the base cycle's "
           f"{against[0]:.3e} and {against[1]:.3e} of the totals (tol "
           f"1e-6)") + f"; {card}")
    if got != per or bad or not drift < 1e-6 or not max(against) < 1e-6:
        raise AssertionError(f"[{tag}] {label}: launches {got} (expected "
                             f"{per}), non-finite {bad}, drift {drift}, "
                             f"contents against the base {against}")


def phase_options(dev, card):
    """``[options]`` lines: configs/global_half_deg with
    torch_gates.OPTIONS_OVERRIDE (the barotropic drags, GL90, KHTR's
    passivity and cap, the boundary-layer diffusion, CVMix convection and
    double diffusion) through the CLI for OPTIONS_DAYS
    (:func:`_cli_phase`, the split diabatic solve is one launch); then in
    this process from the CLI's restart one profiled cycle (the device's
    idle share) whose split diabatic solve is captured and held bitwise,
    one cycle with DIABATIC_FIRST and one with HOMOGENIZE_FORCINGS
    (:func:`_variant_cycle`; the small directory card against CPU,
    :func:`_options_small`, runs beside the gates).  ``card`` (the card's
    name and power limit as nvidia-smi gives them) ends each measured
    line.  Returns the launches of the CLI's cycles."""
    import torch_gates
    from mom6_tpu_torch.tracers import vert_diff

    def options(p):
        return (f"BT_LIN_DRAG {p.dyn.bt.lin_drag}, BT_CDRAG {p.dyn.bt.cdrag}"
                f", KD_GL90 {p.dyn.kappa_gl90} (HBBL_GL90 {p.dyn.hbbl_gl90})"
                f", KHTR_PASSIVITY_COEFF {p.khtr_passivity_coeff}, KHTR_MAX "
                f"{p.khtr_max}, LBD_KHTR {p.khtr_bl}, KD_CONV "
                f"{p.diabatic.convection.kd_conv}, DOUBLE_DIFFUSION")
    ms, st, t_s, t_build, per, launches = _cli_phase(
        dev, "options", torch_gates.OPTIONS_OVERRIDE, OPTIONS_DAYS,
        _options_on, options, card)
    G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing

    def cycle(x, kw):
        with torch.inference_mode():
            return step_mom(x, f, G, GV, p.replace(**kw))
    cycle(st, {})                         # warm: the allocator's pools
    ms_cycle = _timed_cycle(lambda x: cycle(x, {}), st)
    prof = []
    seen = _captured_solves(vert_diff, lambda: prof.append(
        _profile(lambda x: cycle(x, {}), st, "options")))
    dev_ms, n_kern, blocked = prof[0]
    shared = _check_split_solve(seen, (GLOBAL_SHAPE[0], 2) + GLOBAL_SHAPE[1:])
    log(f"[options] from the CLI's restart (t = {t_s:.0f} s; the build "
        f"{t_build:.1f} s): one cycle {ms_cycle:.2f} wall ms (host clock, "
        f"synchronised); profiler, one cycle: {n_kern} kernels, "
        f"{dev_ms:.3f} ms of device time, device idle "
        f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}%, host blocked on a full "
        f"command buffer {blocked:.3f} ms; the captured diabatic solve: T "
        f"and S with coefficients of their own, d {shared} (phase 3's "
        f"SPLIT_TRIDIAG), float32 and float64 bitwise equal to the plain "
        f"version; {card}")
    if shared not in SPLIT_TRIDIAG:
        raise AssertionError(f"[options] captured {shared}: phase 3 checks "
                             f"{SPLIT_TRIDIAG}")
    for kw in OPTION_ORDERINGS:
        _variant_cycle("options", lambda x: cycle(x, kw), st, G, str(kw),
                       per, ("h", "u", "v", "T", "S"), card)
    return launches


# ---------------------------------------------------------------------------
# phase 18: the lateral options through the CLI (tests/torch_gates.py::
# LATERAL_OVERRIDE on configs/global_half_deg)

# thermo cycles through the CLI (the one-scheme cycles run in this
# process from its restart)
LATERAL_CYCLES = 2
# the schemes stepped one cycle each beside the override's
# ARAKAWA_LAMB_BLEND
LATERAL_SCHEMES = ("SADOURNY75_ENSTRO", "ARAKAWA_HSU90", "ARAKAWA_LAMB81")
# the small directory card against CPU in float64: cycles with the
# override, then one with each other scheme
N_SMALL_LATERAL_CYCLES = 2


def _lateral_on(p, G):
    hv = p.hor_visc
    return (hv is not None and hv.leith_lap_const > 0.0 and hv.use_qg_leith
            and hv.kh_aniso > 0.0 and hv.aniso_mode == 2
            and p.meke is not None and p.meke.ku_coeff > 0.0
            and p.meke.fr_coeff > 0.0 and p.zb is not None
            and p.interface_filter is not None and p.porous is not None
            and p.dyn.coriolis_scheme == "ARAKAWA_LAMB_BLEND"
            and G.fold_north)


def _captured_porous_flux(run, face3d=True):
    """Run ``run()`` with the PPM flux kernel's launches recording the first
    one with the Newton terms in each direction whose face is a field of
    each layer (``face3d``, the porous barriers') or a plane; returns {"x"
    or "y": (the nine inputs, {"fold": ...} for y)} (the launches go on,
    and are counted, as usual)."""
    seen = {}
    orig = cppm._flux_launch

    def record(name, h, h_l, h_r, face, d_p, d_m, w, dw, rem, direction,
               fold=False):
        key = "x" if direction == cppm._DIR_X else "y"
        if (face.dim() == 3) == face3d and dw is not None \
                and key not in seen:
            seen[key] = ([t.clone() for t in (h, h_l, h_r, face, d_p, d_m, w,
                                              dw, rem)],
                         {} if key == "x" else {"fold": bool(fold)})
        return orig(name, h, h_l, h_r, face, d_p, d_m, w, dw, rem, direction,
                    fold)
    cppm._flux_launch = record
    try:
        run()
    finally:
        cppm._flux_launch = orig
    return seen


def _check_captured_porous_flux(seen, tag="lateral", face3d=True):
    """Each captured flux call (:func:`_captured_porous_flux`), float32 as
    captured and float64, kernel against plain bitwise; x, and y across
    the fold."""
    if set(seen) != {"x", "y"} or not seen["y"][1].get("fold"):
        raise AssertionError(f"[{tag}] captured {sorted(seen)} "
                             f"({ {k: v[1] for k, v in seen.items()} })")
    shapes = {}
    for direction, (args, kw) in seen.items():
        flux = cppm.zonal_flux if direction == "x" else cppm.merid_flux
        d = cppm._DIR_X if direction == "x" else cppm._DIR_Y
        if (args[3].dim() == 3) != face3d:
            raise AssertionError(f"[{tag}] {direction} face "
                                 f"{tuple(args[3].shape)}")
        for dtype in (torch.float32, torch.float64):
            a = [t.to(dtype) for t in args]
            got = flux(*a[:7], dw=a[7], rem=a[8], **kw)
            want = cppm.ppm_flux_plain(*a, d, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"[{tag}] captured {direction} flux "
                                     f"{dtype}: not bitwise")
        shapes[direction] = tuple(args[0].shape)
    return shapes


def _lateral_small(dev):
    """The lateral options' directory, ANISOTROPIC_MODE 2 included, card
    against CPU (:func:`_small_card_vs_cpu`): N_SMALL_LATERAL_CYCLES
    cycles, then one with each of LATERAL_SCHEMES; E_meke everywhere."""
    import torch_gates

    def scheme(s):
        return lambda p: p.replace(dyn=p.dyn.replace(coriolis_scheme=s))
    runs = [(lambda p: p, "ARAKAWA_LAMB_BLEND")] * N_SMALL_LATERAL_CYCLES \
        + [(scheme(s), s) for s in LATERAL_SCHEMES]
    _small_card_vs_cpu(dev, "lateral", "the lateral options (mode 2)",
                       torch_gates.LATERAL_OVERRIDE, runs,
                       ("h", "T", "S", "u", "v", "E_meke"))


def phase_lateral(dev, card):
    """``[lateral]`` lines: configs/global_half_deg with
    torch_gates.LATERAL_OVERRIDE (MEKE's backscatter and friction source,
    Leith with QG Leith, the flow-aligned anisotropic viscosity, ZB2020,
    the interface filter, the porous barriers, ARAKAWA_LAMB_BLEND)
    through the CLI for LATERAL_CYCLES cycles (:func:`_cli_phase`); the
    grid's row 0 without a wet u or h point (the masks zero what the
    Coriolis schemes' jm1 brings from the fold row); then in this process
    from the CLI's restart a cycle whose PPM fluxes with a per-layer face
    are captured (x, and y across the fold) and held bitwise in float32
    and float64, a timed cycle, a profiled one (the device's idle share),
    and one cycle with each of LATERAL_SCHEMES (:func:`_variant_cycle`;
    the small directory card against CPU, :func:`_lateral_small`, runs
    beside the gates).  ``card`` ends each measured line.  Returns the
    launches of the CLI's cycles."""
    import torch_gates

    def options(p):
        hv = p.hor_visc
        return (f"MEKE_VISCOSITY_COEFF_KU {p.meke.ku_coeff}, MEKE_FRCOEFF "
                f"{p.meke.fr_coeff}, LEITH_LAP_CONST {hv.leith_lap_const} "
                f"(QG {hv.use_qg_leith}), KH_ANISO {hv.kh_aniso} (mode "
                f"{hv.aniso_mode}), ZB_SCALING {p.zb.amplitude}, "
                f"INTERFACE_FILTER_TIME_SCALE "
                f"{p.interface_filter.time_scale}, POROUS_BARRIER, "
                f"CORIOLIS_SCHEME {p.dyn.coriolis_scheme}")
    ms, st, t_s, t_build, per, launches = _cli_phase(
        dev, "lateral", torch_gates.LATERAL_OVERRIDE,
        LATERAL_CYCLES * 7200.0 / 86400.0, _lateral_on, options, card)
    G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing
    if bool(G.mask2dCu[0].any()) or bool(G.mask2dT[0].any()):
        raise AssertionError("[lateral] row 0 holds water: the Coriolis "
                             "schemes' jm1 there reads the fold row")

    def cycle(x, scheme=None):
        q = p if scheme is None else p.replace(
            dyn=p.dyn.replace(coriolis_scheme=scheme))
        with torch.inference_mode():
            return step_mom(x, f, G, GV, q)
    # the first cycle (the allocator's pools) with its fluxes captured
    seen = _captured_porous_flux(lambda: cycle(st))
    shapes = _check_captured_porous_flux(seen)
    ms_cycle = _timed_cycle(cycle, st)
    dev_ms, n_kern, blocked = _profile(cycle, st, "lateral")
    log(f"[lateral] from the CLI's restart (t = {t_s:.0f} s; the build "
        f"{t_build:.1f} s): row 0 without water; one cycle "
        f"{ms_cycle:.2f} wall ms (host clock, synchronised); profiler, one "
        f"cycle: {n_kern} kernels, {dev_ms:.3f} ms of device time, device "
        f"idle {100.0 * (1.0 - dev_ms / ms_cycle):.1f}%, host blocked on a "
        f"full command buffer {blocked:.3f} ms; the PPM flux with a "
        f"per-layer face captured from the cycle, x {shapes['x']} and y "
        f"across the fold {shapes['y']}, float32 and float64 bitwise equal "
        f"to the plain version; {card}")
    for scheme in LATERAL_SCHEMES:
        _variant_cycle("lateral", lambda x: cycle(x, scheme), st, G, scheme,
                       per, ("h", "u", "v", "T", "S", "E_meke"), card)
    return launches


# ---------------------------------------------------------------------------
# phase 19: the Stanley correction with WRIGHT_FULL, the scalar and the
# harmonic SAL, SPPT and SKEB through the CLI (tests/torch_gates.py::
# STOCH_OVERRIDE on configs/global_half_deg); the three new equations of
# state at (32, 400, 720); the tide on configs/neverworld

# thermo cycles through the CLI (a captured, a timed and a profiled cycle
# follow in this process from its restart)
STOCH_CYCLES = 2
# configs/neverworld with the tide, four constituents and the harmonic SAL
# in float64, a stats line a cycle: card against CPU, and 2 + 2 cycles on
# the card against 4 straight ones
TIDES_OVERRIDE = ("DOUBLE_PRECISION = True\nTIDES = True\n"
                  "TIDE_CONSTITUENTS = M2, S2, K1, O1\nSAL_HARMONICS = True\n")
TIDES_CYCLES = 4
# [eos]: the card at (32, 400, 720), the CPU on every EOS_STRIDE-th row
# and column of the same inputs (the functions are elementwise)
EOS_NAMES = ("WRIGHT_FULL", "UNESCO", "ROQUET_RHO")
EOS_STRIDE = 10
EOS_TOL = 1e-10
# UNESCO's derivatives are centred differences (step 1e-4) of the density
# (the second ones of its tangents): an ulp of the density near 1e3 kg
# m-3, where the card's pow and the C library's part, over the 2e-4 step
# is 5.7e-10, ~3e-9 of drho_dT
EOS_TOL_UNESCO = 1e-8


def _stoch_on(p, G):
    return (p.eos_name == "WRIGHT_FULL" and p.stanley_coeff >= 0.0
            and p.dyn.bt.sal_scalar > 0.0 and p.sal_harmonics is not None
            and p.sppt is not None and p.skeb_scale > 0.0 and G.fold_north)


def _check_stoch_captured(solve, coef):
    """The captured diabatic Thomas solve and remap, float32 as captured
    and float64, kernel against plain bitwise; returns their d's and
    coef's shapes."""
    for dtype in (torch.float32, torch.float64):
        a = [t.to(dtype) for t in solve]
        r = [t.to(dtype) for t in coef]
        got = (solvers.tridiag_solve(*a), remap._remap_launch(*r))
        want = (solvers.tridiag_solve_plain(*a),
                remap.remap_integrals_plain(*r))
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"[stoch] captured solve or remap {dtype}: "
                                 "not bitwise")
    return tuple(solve[3].shape), tuple(coef[0].shape)


def phase_stoch(dev, card):
    """``[stoch]`` lines: configs/global_half_deg with
    torch_gates.STOCH_OVERRIDE (WRIGHT_FULL with the Stanley correction,
    the scalar and the harmonic SAL, SPPT and SKEB) through the CLI for
    STOCH_CYCLES cycles (:func:`_cli_phase`: mass drift under 1e-6, salt
    drift under 1e-5 (SPPT perturbs the diabatic change; the budget is
    the remap's), launches exactly ``fold_cycle(6)``); then in this
    process from the CLI's restart (the patterns and the key with it) a
    cycle whose diabatic Thomas solve, PPM fluxes (x, and y
    across the fold) and remap are captured and held bitwise in float32
    and float64, a timed cycle and a profiled one (the device's idle
    share), max |u| and the patterns' spread, and one cycle without
    SKEB's increment (:func:`_variant_cycle`).  ``card`` ends each measured
    line.  Returns the launches of the CLI's cycles."""
    import torch_gates

    def options(p):
        return (f"EQN_OF_STATE {p.eos_name}, STANLEY_COEFF "
                f"{p.stanley_coeff}, SAL_SCALAR_VALUE {p.dyn.bt.sal_scalar}, "
                f"SAL_HARMONICS (degree {p.sal_harmonics.nmax}), SPPT "
                f"(amplitude {p.sppt.amplitude}, tau {p.sppt.tau} s), "
                f"SKEB_SCALE {p.skeb_scale}")
    ms, st, t_s, t_build, per, launches = _cli_phase(
        dev, "stoch", torch_gates.STOCH_OVERRIDE,
        STOCH_CYCLES * 7200.0 / 86400.0, _stoch_on, options, card)
    G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing
    if not bool(st.sppt_pattern.abs().max() > 0):
        raise AssertionError("[stoch] the restart's pattern not restored")

    def cycle(x, **kw):
        with torch.inference_mode():
            return step_mom(x, f, G, GV, p.replace(**kw))
    from mom6_tpu_torch.tracers import vert_diff
    out, solves, coef = [], [], []
    fluxes = _captured_porous_flux(lambda: solves.extend(_captured_solves(
        vert_diff, lambda: coef.extend(_captured_remaps(
            lambda: out.append(cycle(st)))[0]))), face3d=False)
    flux_shapes = _check_captured_porous_flux(fluxes, "stoch", face3d=False)
    solve_shape, coef_shape = _check_stoch_captured(solves[0], coef)
    ms_cycle = _timed_cycle(cycle, st)
    dev_ms, n_kern, blocked = _profile(cycle, st, "stoch")
    s1 = out[0]
    log(f"[stoch] from the CLI's restart (t = {t_s:.0f} s; the build "
        f"{t_build:.1f} s): one cycle {ms_cycle:.2f} wall ms (host clock, "
        f"synchronised); profiler, one cycle: {n_kern} kernels, "
        f"{dev_ms:.3f} ms of device time, device idle "
        f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}%, host blocked on a full "
        f"command buffer {blocked:.3f} ms; captured from the cycle and held "
        f"bitwise in float32 and float64: the diabatic Thomas solve d "
        f"{solve_shape}, the PPM flux x {flux_shapes['x']} and y across "
        f"the fold {flux_shapes['y']}, the remap coef {coef_shape}; max |u| {float(st.u.abs().max()):.4f} m/s at "
        f"the restart, {float(s1.u.abs().max()):.4f} after the cycle; the "
        f"patterns' std: SPPT {float(s1.sppt_pattern.std()):.4f}, SKEB "
        f"{float(s1.skeb_pattern.std()):.4f}, the key {s1.rng_key.tolist()}; "
        f"{card}")
    for k in ("h", "u", "v", "T", "S", "sppt_pattern", "skeb_pattern"):
        if not bool(torch.isfinite(getattr(s1, k)).all()):
            raise AssertionError(f"[stoch] {k} not finite")
    # what moves the flow: the same cycle without SKEB's increment
    _variant_cycle("stoch", lambda x: cycle(x, skeb_scale=0.0), st, G,
                   "SKEB off", per, ("h", "u", "v", "T", "S"), card)
    return launches


def phase_rng(dev, card):
    """``[rng]`` line: the port's threefry on the card against the CPU
    (which draws JAX's streams, tests/test_torch_stoch_tides.py): keys,
    splits, fold_in, the 32- and 64-bit words and the uniforms at
    (400, 720) to the bit, the normals' largest ulp distance in float32
    and float64 (the card's logarithm on erfinv's large branch), and
    three float64 AR(1) steps of a (400, 720) pattern within 1e-10 of
    max-abs."""
    from mom6_tpu_torch.framework import random as rnd
    from mom6_tpu_torch.physics.stochastic import SPPTParams, ar1_pattern
    shape = GLOBAL_SHAPE[1:]
    ulps = {}
    for seed in (0, 7, 2 ** 31 - 1):
        kc, kd = rnd.PRNGKey(seed), rnd.PRNGKey(seed, device=dev)
        same = [torch.equal(rnd.split(kd).cpu(), rnd.split(kc)),
                torch.equal(rnd.fold_in(kd, 5).cpu(), rnd.fold_in(kc, 5))]
        same += [torch.equal(rnd.bits(kd, shape, w).cpu(),
                             rnd.bits(kc, shape, w)) for w in (32, 64)]
        for dtype, iv in ((torch.float32, torch.int32),
                          (torch.float64, torch.int64)):
            same.append(torch.equal(rnd.uniform(kd, shape, dtype).cpu(),
                                    rnd.uniform(kc, shape, dtype)))
            a = rnd.normal(kd, shape, dtype).cpu().view(iv).long()
            b = rnd.normal(kc, shape, dtype).view(iv).long()
            ulps[str(dtype)[6:]] = max(ulps.get(str(dtype)[6:], 0),
                                       int((a - b).abs().max()))
        if not all(same):
            raise AssertionError(f"[rng] seed {seed}: the card's stream "
                                 f"parts from the CPU's ({same})")
    pats = []
    for d in ("cpu", dev):
        pat = torch.zeros(shape, dtype=torch.float64, device=d)
        key = rnd.PRNGKey(3, device=d)
        for _ in range(3):
            pat, key = ar1_pattern(pat, key, 7200.0, SPPTParams())
        pats.append((pat.cpu(), key.cpu()))
    err = rel_err(pats[1][0], pats[0][0])
    log(f"[rng] threefry on the card against the CPU at {shape}: keys, "
        f"splits, fold_in, 32- and 64-bit words and float32/float64 "
        f"uniforms bitwise; normals within {ulps} ulps; three float64 AR(1) "
        f"steps of the pattern {err:.3e} of max-abs (tol 1e-10), keys "
        f"equal; {card}")
    if not (err <= 1e-10 and torch.equal(pats[0][1], pats[1][1])
            and max(ulps.values()) <= 4):
        raise AssertionError(f"[rng] pattern {err}, normals {ulps} ulps")


def phase_eos(dev, card):
    """``[eos]`` lines: density, the first and the second derivatives of
    WRIGHT_FULL, UNESCO and ROQUET_RHO at (32, 400, 720): the card's ms in
    float32 (CUDA events, median of 5), every value finite; float64 on
    the card against the CPU on every EOS_STRIDE-th row and column of the
    same inputs within EOS_TOL of max-abs (UNESCO's derivatives
    EOS_TOL_UNESCO)."""
    rng = np.random.default_rng(29)
    nz = GLOBAL_SHAPE[0]
    T = rng.uniform(-2.0, 30.0, GLOBAL_SHAPE)
    S = rng.uniform(30.0, 38.0, GLOBAL_SHAPE)
    p = (np.linspace(0.0, 5e7, nz)[:, None, None]
         * rng.uniform(0.9, 1.1, GLOBAL_SHAPE))
    sub = (slice(None), slice(None, None, EOS_STRIDE),
           slice(None, None, EOS_STRIDE))
    for name in EOS_NAMES:
        e = get_eos(name)
        fns = {"density": lambda *a: (e.density(*a),),
               "derivs": e.density_derivs,
               "second": e.density_second_derivs}
        x32 = [torch.tensor(a, dtype=torch.float32, device=dev)
               for a in (T, S, p)]
        ms = {k: median_ms(lambda fn=fn: fn(*x32), reps=5, warm=1)
              for k, fn in fns.items()}
        x64 = [torch.tensor(a, dtype=torch.float64, device=dev)
               for a in (T, S, p)]
        xc = [torch.tensor(a[sub], dtype=torch.float64) for a in (T, S, p)]
        errs = {}
        for k, fn in fns.items():
            got = fn(*x64)
            if not all(bool(torch.isfinite(g).all()) for g in fn(*x32)):
                raise AssertionError(f"[eos] {name} {k} float32 not finite")
            for i, (g, w) in enumerate(zip(got, fn(*xc))):
                errs[f"{k}[{i}]"] = rel_err(g[sub].cpu(), w)
        bad = {k: v for k, v in errs.items()
               if v > (EOS_TOL_UNESCO if name == "UNESCO"
                       and k != "density[0]" else EOS_TOL)}
        top = max(errs, key=errs.get)
        log(f"[eos] {name} at {GLOBAL_SHAPE}: float32 on the card "
            f"density {ms['density']:.3f} ms, first derivatives "
            f"{ms['derivs']:.3f} ms, second derivatives (forward mode) "
            f"{ms['second']:.3f} ms; float64 card against CPU on every "
            f"{EOS_STRIDE}th row and column: largest {errs[top]:.3e} of "
            f"max-abs ({top}); {card}")
        if bad:
            raise AssertionError(f"[eos] {name} card against CPU: {bad}")


def phase_tides(dev):
    """``[tides]`` lines: configs/neverworld with TIDES_OVERRIDE through
    the CLI in float64: TIDES_CYCLES cycles on the card against the CPU
    (ocean.stats to 1e-12 and 1e-9, the restart's fields to 1e-10 of
    max-abs, :func:`_card_against_cpu`), and on the card half and half
    from the first half's restart against the straight run, to the bit
    (the time restarted)."""
    import shutil
    ov = TIDES_OVERRIDE + \
        f"ENERGYSAVEDAYS = {_cycle_days('neverworld', 1)}\n"
    card, first, cpu = (_solo_dir("neverworld", sub, ov)
                        for sub in ("tides_card", "tides_first", "tides_cpu"))
    n, half = (_cycle_days("neverworld", k)
               for k in (TIDES_CYCLES, TIDES_CYCLES // 2))
    secs = _run_solo([(card, ["--days", n]), (first, ["--days", half]),
                      (cpu, ["--days", n, "--device", "cpu"])])
    second = _solo_dir("neverworld", "tides_second", ov)
    shutil.copy(os.path.join(first, "RESTART", "ocean_solo.res"), second)
    secs.update(_run_solo([(second, ["--days", half, "--restart-in",
                                     os.path.join(first, "MOM.res.nc")])]))
    from mom6_tpu_torch.io.netcdf import read_nc
    a = read_nc(os.path.join(card, "MOM.res.nc"))
    b = read_nc(os.path.join(second, "MOM.res.nc"))
    diff = [k for k in a if k != "__step__"
            and not np.array_equal(a[k], b.get(k))]
    if diff or sorted(a) != sorted(b) or "time" not in a:
        raise AssertionError(f"[tides] split run: {diff} {sorted(a)}")
    errs = _card_against_cpu("[tides] neverworld", card, cpu)
    log(f"[tides] neverworld f64 with TIDES ({TIDES_OVERRIDE.splitlines()[2]}"
        f") and SAL_HARMONICS, {TIDES_CYCLES} cycles through the CLI: card "
        f"against CPU, relative differences of ocean.stats and of the "
        f"restart fields (of max-abs) {errs}; on the card "
        f"{TIDES_CYCLES // 2} + {TIDES_CYCLES // 2} cycles (--restart-in) "
        f"equal {TIDES_CYCLES} straight ones to the bit in all "
        f"{len(a) - 2} restart fields, time {float(a['time'][0]):.0f} s; "
        f"max |u| {float(np.abs(a['u']).max()):.4f} m/s; {secs[card]:.1f} s "
        f"on the card, {secs[cpu]:.1f} s on the CPU (each with its "
        f"process)")


# ---------------------------------------------------------------------------
# phase 12: the port's command line, python -m mom6_tpu_torch.drivers.solo

HYBGEN_CYCLES = 3
# the climatology's seed
HYBGEN_SEED = 11
# [m/s] the bound on max |u| after the CLI's cycles from the from_Z build
# at rest and after the next cycle (2.2 after three cycles with this
# climatology, 6.4 in the first with its land at the nearest model
# point's depth: tools/torch_hybgen_spinup.py)
HYBGEN_MAX_U = 4.0


def _hybgen_on(p, G):
    return (p.ale.mode == "HYBGEN" and p.ale.scheme == "PPM_H6"
            and len(p.ale.rho_targets) == 32 and G.fold_north)


def phase_hybgen(dev, ms_global, card):
    """``[hybgen]`` lines: configs/global_half_deg with
    torch_gates.HYBGEN_OVERRIDE (HYBGEN with 32 targets and HYCOM's
    minimum z profile, PPM_H6, TS_CONFIG = from_Z) through the CLI for
    HYBGEN_CYCLES cycles, from a climatology that the phase writes first
    (torch_gates.write_climatology: World Ocean Atlas 2018's 1-degree
    layout, 360x180 and 102 levels, values from HYBGEN_SEED, its land
    from the model's topography, each cell as deep as its deepest model
    T point; tools/torch_hybgen_spinup.py shows why): mass drift under
    1e-6, salt drift under 1e-5, launches exactly ``fold_cycle(6)`` a
    cycle plus the build's two remaps (z_init's T and S).  Then the
    build in this process (its seconds and the fill's relaxation passes),
    whose z_init remap of T is captured; from the CLI's restart a cycle
    whose T/S (PPM_H6) and u remaps are captured (max |u| after the CLI's
    cycles and after it under HYBGEN_MAX_U), a timed and a profiled cycle
    (the device's idle share), and a cycle with P3M_H4 (the quartic
    instance; its heat and salt held to the PPM_H6 cycle's) whose T/S
    remap is captured: each captured launch held bitwise in float32 and
    float64 and timed (:func:`_check_remap_site`).  Returns the launches
    of the CLI's cycles."""
    import torch_gates
    from mom6_tpu_torch.grid import horiz_regrid
    clim = {}

    def prepare(d):
        t0 = time.time()
        clim["missing"] = torch_gates.write_climatology(
            os.path.join(d, "clim_z.nc"), ms_global.grid, HYBGEN_SEED,
            land="deepest")
        clim["seconds"] = time.time() - t0

    def options(p):
        a = p.ale
        return (f"REGRIDDING_COORDINATE_MODE HYBGEN ({len(a.rho_targets)} "
                f"targets {a.rho_targets[0]:.4f}-{a.rho_targets[-1]:.4f} "
                f"kg m-3, relaxation {a.hybgen_qrlx}, minimum z profile "
                f"{a.dz_nominal[0]:.1f}-{max(a.dz_nominal):.1f} m), "
                f"REMAPPING_SCHEME {a.scheme}, TS_CONFIG from_Z "
                f"(clim_z.nc 360x180x102, {100 * clim['missing']:.1f}% "
                f"missing, its land at the deepest model depth of each "
                f"cell, written in {clim['seconds']:.1f} s)")
    zinit = []

    def in_build(build):
        horiz_regrid.fill_missing.passes = 0
        zinit.extend(_captured_remaps(build))
    ms, st, t_s, t_build, per, launches = _cli_phase(
        dev, "hybgen", torch_gates.HYBGEN_OVERRIDE,
        HYBGEN_CYCLES * 7200.0 / 86400.0, _hybgen_on, options, card,
        prepare=prepare, build_launches={"remap": 2}, in_build=in_build)
    passes = horiz_regrid.fill_missing.passes
    G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing
    if len(zinit) != 2:
        raise AssertionError(f"[hybgen] the build launched {len(zinit)} "
                             "remaps (z_init's T and S expected)")
    wet = G.mask2dT > 0.5
    T0 = ms.state.T[wet.expand_as(ms.state.T)]
    log(f"[hybgen] the from_Z build in this process: {t_build:.1f} s (the "
        f"climatology read, interpolated and filled on the host for T and "
        f"S, 102 levels each, {passes} relaxation passes; the remap from "
        f"102 levels to 32 layers on the card, 2 launches); wet T in "
        f"[{float(T0.min()):.4f}, {float(T0.max()):.4f}] degC; {card}")

    def cycle(x, **kw):
        with torch.inference_mode():
            return step_mom(x, f, G, GV, p.replace(**kw))

    out = []
    seen = _captured_remaps(lambda: out.append(cycle(st)))
    if len(seen) != 3:
        raise AssertionError(f"[hybgen] a cycle launched {len(seen)} remaps")
    ms_cycle = _timed_cycle(cycle, st)
    dev_ms, n_kern, blocked = _profile(cycle, st, "hybgen")
    s1 = out[0]
    hw = s1.h[wet.expand_as(s1.h)]
    log(f"[hybgen] from the CLI's restart (t = {t_s:.0f} s): one cycle "
        f"{ms_cycle:.2f} wall ms (host clock, synchronised); profiler, one "
        f"cycle: {n_kern} kernels, {dev_ms:.3f} ms of device time, device "
        f"idle {100.0 * (1.0 - dev_ms / ms_cycle):.1f}%, host blocked on a "
        f"full command buffer {blocked:.3f} ms; launches a cycle exactly "
        f"fold_cycle(6) (HYBGEN's regrid and unmixing add none: eager "
        f"PyTorch); layers under 1 m: {100.0 * float((hw < 1.0).float().mean()):.1f}% "
        f"of the wet cells; max |u| {float(s1.u.abs().max()):.4f} m/s; "
        f"{card}")
    for k in ("h", "u", "v", "T", "S"):
        if not bool(torch.isfinite(getattr(s1, k)).all()):
            raise AssertionError(f"[hybgen] {k} not finite")
    speed = max(float(x.u.abs().max()) for x in (st, s1))
    if not speed < HYBGEN_MAX_U:
        raise AssertionError(f"[hybgen] max |u| {speed} m/s after the "
                             f"CLI's cycles or the next")
    _check_remap_site("hybgen", "z_init's PLM remap of T", zinit[0])
    _check_remap_site("hybgen", "HYBGEN's T/S after PPM_H6", seen[0])
    _check_remap_site("hybgen", "HYBGEN's u after PPM_H6", seen[1])
    per_p3m = dict(per, remap_npoly5=per["remap"])
    quartic, q_out = [], []

    def p3m_cycle(x):
        # its remaps captured as they launch (the launches go on, counted)
        quartic.extend(_captured_remaps(lambda: q_out.append(cycle(
            x, ale=dataclasses.replace(p.ale, scheme="P3M_H4")))))
        return q_out[-1]
    _variant_cycle("hybgen", p3m_cycle, st, G, "P3M_H4", per_p3m,
                   ("h", "u", "v", "T", "S"), card, base=s1)
    _check_remap_site("hybgen", "HYBGEN's T/S after P3M_H4", quartic[0])
    return launches


ICE_SOLO_TEXT = ("NIGLOBAL = 80\nNJGLOBAL = 640\nLENLON = 80.0\n"
                 "LENLAT = 640.0\n")
ICE_SOLO_DAYS = 3
# the card-against-CPU solve that does not depend on convergence
SSA_CUT = dict(n_picard=1, n_cg=3)


def phase_ice_solo(dev, card):
    """``[ice_solo]`` lines: the ice-only driver as users run it, ``python
    -m mom6_tpu_torch.drivers.ice_solo DIR --days ICE_SOLO_DAYS``, on the
    extent and spacing of the MISMIP+ ice domain (640 km by 80 km at 1 km,
    Asay-Davis et al. 2016; the driver's wedge thins in y, so NIGLOBAL =
    80 and NJGLOBAL = 640) with the driver's defaults otherwise (daily
    steps, 8 Picard iterations of 60 CG iterations: 480 applications of
    the SSA operator a step): ice.stats finite, the volume and area
    drift; then in this process a timed step and a profiled one (kernels
    a step, the device's idle share); in float64 on that grid and wedge,
    the card against the CPU: one viscosity and one operator application
    at the CPU's solved velocities and the solve cut to SSA_CUT (1e-10 of
    the max-abs), and the driver's whole solve beside the CPU's own
    difference for a thickness one ulp larger (10 times that), with each
    Picard iteration's CG residual."""
    from mom6_tpu_torch.drivers import ice_solo
    from mom6_tpu_torch.physics.ice_shelf_dynamics import (_apply_ssa,
                                                           _glen_visc,
                                                           ssa_solve)
    d = os.path.join(SOLO_OUT, "ice_solo")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "MOM_input"), "w") as fh:
        fh.write(ICE_SOLO_TEXT)
    run = _start_solo(d, ["--days", str(ICE_SOLO_DAYS)], driver="ice_solo")
    secs = _end_solo(d, run)
    rows = []
    with open(os.path.join(d, "ice.stats")) as fh:
        for ln in fh:
            m = re.search(r"Vol (\S+)\s+Area (\S+)\s+max\|u\|\s+(\S+)", ln)
            if m:
                rows.append([float(x) for x in m.groups()])
    if not rows or not all(math.isfinite(x) for r in rows for x in r):
        raise AssertionError(f"[ice_solo] ice.stats: {rows}")
    pf = ParamFile([os.path.join(d, "MOM_input")])
    setup = ice_solo.build(pf, dev)
    G = setup.grid
    area = (G.areaT.double() * (setup.h_ice > 1.0)).sum()
    vol0 = float((setup.h_ice.double() * G.areaT.double()).sum())
    vol_drift = rows[-1][0] / vol0 - 1.0
    area_drift = rows[-1][1] / float(area) - 1.0
    u = torch.zeros_like(setup.h_ice)

    def step(x):
        with torch.inference_mode():
            return ice_solo.step(setup, x, u, u)
    step(setup.h_ice)
    ms_step = _timed_cycle(step, setup.h_ice)
    dev_ms, n_kern, blocked = _profile(step, setup.h_ice, "ice_solo")
    log(f"[ice_solo] python -m mom6_tpu_torch.drivers.ice_solo (80 x 640 "
        f"cells of 1 km, {ICE_SOLO_DAYS} daily steps): process {secs:.1f} "
        f"s; ice.stats: volume {rows[-1][0]:.6e} m3 (drift {vol_drift:+.3e} "
        f"of the wedge's), area {rows[-1][1]:.6e} m2 (drift "
        f"{area_drift:+.3e}), max |u| {rows[-1][2]:.2f} m/yr; one step in "
        f"this process {ms_step:.2f} wall ms (host clock, synchronised); "
        f"profiler, one step: {n_kern} kernels ({n_kern / 480.0:.1f} an "
        f"operator application), {dev_ms:.3f} ms of device time, device "
        f"idle {100.0 * (1.0 - dev_ms / ms_step):.1f}%, host blocked on a "
        f"full command buffer {blocked:.3f} ms; {card}")
    # float64, the card against the CPU: one viscosity and one operator
    # application at the CPU's solved velocities, and the solve cut to one
    # Picard iteration of SSA_CUT_CG CG iterations (none of these depends
    # on convergence: 1e-10); beside them the driver's whole solve and the
    # CPU's own answer for a thickness one ulp larger (how far round-off
    # moves the 8 x 60 iterations here)
    s64 = {str(w): ice_solo.build(pf, w) for w in (dev, "cpu")}
    out, res = {}, {}
    for tag, where, pp, h_of in (
            ("solve", "cpu", None, lambda h: h),
            ("ulp", "cpu", None, lambda h: torch.nextafter(h, torch.tensor(
                math.inf, dtype=torch.float64))),
            ("solve", dev, None, lambda h: h),
            ("cut", "cpu", SSA_CUT, lambda h: h),
            ("cut", dev, SSA_CUT, lambda h: h)):
        s = s64[str(where)]
        Gd = s.grid.to(dtype=torch.float64)
        params = s.params if pp is None else dataclasses.replace(
            s.params, **pp)
        with torch.inference_mode():
            out[tag, str(where)] = ssa_solve(
                h_of(s.h_ice.double()), Gd, params,
                mask_shelf=s.mask_shelf.double())
        res[tag, str(where)] = ssa_solve.residuals.cpu().tolist()
    ref = out["solve", "cpu"]
    speed = max(float(a.abs().max()) for a in ref)

    def diff(x, y):
        return max(float((a.cpu() - b.cpu()).abs().max())
                   for a, b in zip(x, y)) / max(
                       max(float(b.abs().max()) for b in y), 1e-300)
    ops = {}
    for where in (dev, "cpu"):
        s = s64[str(where)]
        Gd = s.grid.to(dtype=torch.float64)
        h = s.h_ice.double()
        uc, vc = (a.to(h.device) for a in ref)
        with torch.inference_mode():
            nu_h = _glen_visc(uc, vc, h, Gd, s.params)
            area = Gd.areaT
            m = s.mask_shelf.double()
            ops[str(where)] = (nu_h,) + _apply_ssa(uc, vc, nu_h * m, Gd, m,
                                                   area, 1e3 * m)
    tight = {"viscosity": diff(ops[str(dev)][:1], ops["cpu"][:1]),
             "operator": diff(ops[str(dev)][1:], ops["cpu"][1:]),
             f"1 x {SSA_CUT['n_cg']} solve": diff(out["cut", str(dev)],
                                                  out["cut", "cpu"])}
    err = diff(out["solve", str(dev)], ref)
    sens = diff(out["ulp", "cpu"], ref)
    log(f"[ice_solo] float64 on the 80 x 640 wedge, card against CPU: "
        + ", ".join(f"{k} {v:.3e}" for k, v in tight.items())
        + f" of the max-abs (tol 1e-10); the driver's 8 x 60 ssa_solve "
        f"{err:.3e} of the max speed ({speed * 3.15576e7:.2f} m/yr), the "
        f"CPU against itself with the thickness one ulp larger {sens:.3e} "
        f"(held to 10 times that); CG residual relative to the driving "
        f"stress after each Picard iteration: card "
        + " ".join(f"{r:.3e}" for r in res["solve", str(dev)]) + ", CPU "
        + " ".join(f"{r:.3e}" for r in res["solve", "cpu"]))
    if not (max(tight.values()) <= 1e-10
            and err <= 10.0 * max(sens, 1e-13)):
        raise AssertionError(f"[ice_solo] card against CPU {tight}, the "
                             f"whole solve {err}, one ulp {sens}")


# ---------------------------------------------------------------------------
# phase 22: the RK2b stepper through the CLI; phase 23: the ensemble's data
# assimilation with the diagnostics tools

RK2B_CYCLES = 3
# [m/s] the bound on max |u| after the CLI's RK2b cycles and after the
# next one in the process.  The reference's RK2b grows in float32 on the
# tripolar global configurations, and the port's with it
# (tools/torch_rk2b_growth.py on the CPU, global_2deg in both packages:
# 0.12 m/s after one cycle, 13.4 after 12, RK2 0.13; ROADMAP queue 3); at
# 720x400x32 the fourth cycle reached 20.7 m/s on an H100 (PERF.md §6),
# so this catches a NaN or a faster runaway, not the scheme's own growth
RK2B_MAX_U = 50.0
# the small tripolar model with RK2b, card against CPU one cycle at a time
SMALL_RK2B_CYCLES = 3
SMALL_TOL = 1e-10


def _rk2b_on(p, G):
    return p.dyn.scheme == "RK2B" and G.fold_north


def _flux_forms(run):
    """The forms of every PPM flux launch ``run()`` makes: (direction,
    fold, the face a field of each layer, with the Newton terms)."""
    forms = set()
    orig = cppm._flux_launch

    def record(name, h, h_l, h_r, face, d_p, d_m, w, dw, rem, direction,
               fold=False):
        forms.add(("x" if direction == cppm._DIR_X else "y", bool(fold),
                   face.dim() == 3, dw is not None))
        return orig(name, h, h_l, h_r, face, d_p, d_m, w, dw, rem, direction,
                    fold)
    cppm._flux_launch = record
    try:
        run()
    finally:
        cppm._flux_launch = orig
    return forms


def _means_and_dossier(tag, st, G, dt, card):
    """The six spatial means and the truncation dossier of ``st`` on the
    card against the same on the CPU: equal (the means sum exactly on
    the host; the dossier's argmax takes the first of equal maxima on
    both)."""
    from mom6_tpu_torch.diagnostics import diagnostics as D
    from mom6_tpu_torch.diagnostics.point_accel import (format_dossier,
                                                        worst_cfl_dossier)

    def means(s, g):
        return [D.global_area_mean(s.T[0], g), D.global_area_mean(s.T, g, s.h),
                D.zonal_mean(s.T[0], g), D.meridional_mean(s.S[0], g),
                D.global_layer_mean(s.T, s.h, g),
                D.global_volume_mean(s.S, s.h, g),
                D.global_mass_integral(s.h, g)]
    s_cpu, G_cpu = st.to("cpu"), G.to("cpu")
    t0 = time.time()
    got = means(st, G)
    secs = time.time() - t0
    want = means(s_cpu, G_cpu)
    same = [bool(np.array_equal(np.asarray(a), np.asarray(b)))
            for a, b in zip(got, want)]
    t0 = time.time()
    d_card = worst_cfl_dossier(st, G, dt)
    d_secs = time.time() - t0
    d_cpu = worst_cfl_dossier(s_cpu, G_cpu, dt)
    log(f"[{tag}] the spatial means of the final state (global area mean "
        f"of SST {got[0]:.6f} degC, volume mean of T {got[1]:.6f}, of S "
        f"{got[5]:.6f}, mass {got[6]:.6e} kg, the zonal and meridional "
        f"means of SST and SSS, the layer means of T) card against CPU: "
        f"{sum(same)} of {len(same)} equal to the bit, {secs:.2f} s on the "
        f"card's fields; worst_cfl_dossier "
        f"({d_secs * 1e3:.1f} ms): {format_dossier(d_card).splitlines()[0]}, "
        f"the CPU's the same point and columns: {d_card == d_cpu}; {card}")
    if not all(same) or d_card != d_cpu:
        raise AssertionError(f"[{tag}] means {same}, dossier {d_card} "
                             f"against {d_cpu}")


def _small_rk2b_card_vs_cpu(dev, card):
    """The small tripolar model (32x24x5, global_2deg's MOM_input) with
    SPLIT_RK2B and BT_CONT in float64 from a flowing state, the card
    against the CPU one cycle at a time from the CPU's state: h, the
    RK2b pair, T and S where the layer, u and v where the face holds
    more than 1 mm of water, within SMALL_TOL of max-abs."""
    import torch_gates
    run_dir = os.path.join(OUT, "small_global")
    if not os.path.exists(os.path.join(run_dir, "ocean_hgrid.nc")):
        write_mosaic(run_dir, nx=32, ny_reg=16, ny_cap=8)
    text = SMALL_GLOBAL + "USE_BT_CONT_TYPE = True\n" \
        + torch_gates.RK2B_OVERRIDE
    ms = {w: build_model_from_params(ParamFile(
        [os.path.join(TREE, "configs", "global_2deg", "MOM_input")],
        text=text), dtype=torch.float64, device=w, input_dir=run_dir)
        for w in (dev, "cpu")}
    st = _flowing(ms["cpu"].state, ms["cpu"].grid)
    worst = {}
    with torch.inference_mode():
        for c in range(SMALL_RK2B_CYCLES):
            out = {w: step_mom(st.to(m.grid.mask2dT.device), m.forcing,
                               m.grid, m.vgrid, m.params)
                   for w, m in ms.items()}
            h = out["cpu"].h
            wet = dict(h=None, du_av_inst=None, dv_av_inst=None,
                       T=h > 1e-3, S=h > 1e-3, u=0.5 * (h + ip1(h)) > 1e-3,
                       v=0.5 * (h + jp1(h, "h")) > 1e-3)
            for n, where in wet.items():
                a, b = getattr(out[dev], n).cpu(), getattr(out["cpu"], n)
                if where is not None:
                    a, b = a[where], b[where]
                worst[f"{n}[{c}]"] = rel_err(a, b)
            st = out["cpu"]
    top = max(worst, key=worst.get)
    log(f"[rk2b] card against CPU, float64, the 32x24x5 tripolar model "
        f"with SPLIT_RK2B and BT_CONT from a flowing state, "
        f"{SMALL_RK2B_CYCLES} cycles one at a time from the CPU's state: "
        f"largest {worst[top]:.3e} of max-abs ({top}; tol {SMALL_TOL}); "
        f"du_av_inst after the last {float(st.du_av_inst.abs().max()):.3e} "
        f"m/s; {card}")
    if not worst[top] <= SMALL_TOL:
        raise AssertionError(f"[rk2b] card against CPU {top}: {worst[top]}")


def phase_rk2b(dev, card):
    """``[rk2b]`` lines: configs/global_half_deg with
    torch_gates.RK2B_OVERRIDE (SPLIT_RK2B: the time-filtered velocities
    stepped, the restart pair du_av_inst/dv_av_inst) through the CLI for
    RK2B_CYCLES cycles (:func:`_cli_phase`, launches exactly
    ``rk2b_fold_cycle(6)`` a cycle), its restart holding the pair; then
    in this process from that restart a cycle whose PPM flux forms are
    those of an RK2 cycle, its Newton flux (x, y across the fold)
    captured and held bitwise, a timed and a profiled cycle, the RK2
    cycle from the same state (mass drift, max |u| beside RK2B's and
    where it lies, both under RK2B_MAX_U); the means and the dossier on
    the card against
    the CPU (the small tripolar model card against CPU runs beside the
    gates, :func:`_small_rk2b_card_vs_cpu`).  Returns the launches of the
    CLI's cycles."""
    import torch_gates

    def options(p):
        return (f"SPLIT_RK2B (scheme {p.dyn.scheme}, be {p.dyn.be}, bt "
                f"nstep {p.dyn.bt.nstep})")
    ms, st, t_s, t_build, per, launches = _cli_phase(
        dev, "rk2b", torch_gates.RK2B_OVERRIDE,
        RK2B_CYCLES * 7200.0 / 86400.0, _rk2b_on, options, card,
        per_cycle=rk2b_fold_cycle)
    G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing
    du_max = float(st.du_av_inst.abs().max())
    if not du_max > 0.0:
        raise AssertionError("[rk2b] the restart's du_av_inst is zero")

    def cycle(x, **kw):
        with torch.inference_mode():
            return step_mom(x, f, G, GV, p.replace(**kw))
    out, fluxes, rk2_out = [], {}, []
    forms = _flux_forms(lambda: fluxes.update(_captured_porous_flux(
        lambda: out.append(cycle(st)), face3d=False)))
    flux_shapes = _check_captured_porous_flux(fluxes, "rk2b", face3d=False)
    rk2 = p.dyn.replace(scheme="RK2")
    forms_rk2 = _flux_forms(lambda: rk2_out.append(cycle(st, dyn=rk2)))
    if forms != forms_rk2:
        raise AssertionError(f"[rk2b] flux forms {sorted(forms)} against "
                             f"RK2's {sorted(forms_rk2)}")
    ms_cycle = _timed_cycle(cycle, st)
    dev_ms, n_kern, blocked = _profile(cycle, st, "rk2b")
    s1 = out[0]
    area = (G.areaT * G.mask2dT).double()
    m0 = float((st.h.double() * area).sum())
    drift = abs(float((s1.h.double() * area).sum()) - m0) / m0
    s_rk2 = rk2_out[0]
    u_r, u_b, u_a = (float(x.u.abs().max()) for x in (st, s1, s_rk2))
    k, j, i = np.unravel_index(int(s1.u.abs().argmax()), tuple(s1.u.shape))
    lat = float(G.geoLatT[j, i])
    log(f"[rk2b] from the CLI's restart (t = {t_s:.0f} s; the build "
        f"{t_build:.1f} s; the restored |du_av_inst| up to {du_max:.3e} "
        f"m/s): one cycle {ms_cycle:.2f} wall ms (host clock, "
        f"synchronised); profiler, one cycle: {n_kern} kernels, "
        f"{dev_ms:.3f} ms of device time, device idle "
        f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}%, host blocked on a full "
        f"command buffer {blocked:.3f} ms; launches a cycle exactly "
        f"rk2b_fold_cycle(6) {per}; the PPM flux forms of the cycle those "
        f"of an RK2 cycle ({len(forms)}: {sorted(forms)}), the Newton flux "
        f"captured x {flux_shapes['x']} and y across the fold "
        f"{flux_shapes['y']} held bitwise in float32 and float64; mass "
        f"drift {drift:.3e} (tol 1e-6); max |u| {u_r:.4f} m/s at the "
        f"restart, {u_b:.4f} after the cycle (layer {k}, {lat:.1f} N, i "
        f"{i}), the RK2 cycle from the same state {u_a:.4f} (bound "
        f"{RK2B_MAX_U}); {card}")
    for k in ("h", "u", "v", "T", "S", "du_av_inst", "dv_av_inst"):
        if not bool(torch.isfinite(getattr(s1, k)).all()):
            raise AssertionError(f"[rk2b] {k} not finite")
    if not (drift < 1e-6 and max(u_r, u_b, u_a) < RK2B_MAX_U):
        raise AssertionError(f"[rk2b] mass drift {drift}, max |u| {u_b} "
                             f"against RK2's {u_a}")
    _means_and_dossier("rk2b", s1, G, p.dyn.dt, card)
    return launches


ODA_NE = 4
ODA_OBS = 500
ODA_NOISE = 0.05
ODA_CYCLES = 2
ODA_SEED = 20
ODA_EAKF = dict(inflation=1.12, loc_radius=8.0)
# OM4's count of levels for the external analysis's own grid
ODA_INC_LEVELS = 75
ODA_INC_DEPTH = 6500.0
HA_NAMES = ("M2", "K1", "S2", "O1")
HA_SAMPLES = 96


def _oda_members(st, G, rng, ne=ODA_NE):
    """ne members: the state with a shared large-scale T bias and a
    spread of each member's own (tests/test_oda_cycle.py's build)."""
    import torch_gates
    m = G.mask2dT
    bias = torch_gates._smooth_noise(rng, G.ny, G.nx, amp=2.0)
    return [st.replace(T=st.T + torch.tensor(
        bias + torch_gates._smooth_noise(rng, G.ny, G.nx, amp=1.0),
        dtype=st.T.dtype, device=m.device)[None] * m) for _ in range(ne)]


def _inc_grid(st, G, nzi=ODA_INC_LEVELS, depth=ODA_INC_DEPTH):
    """An analysis grid of its own: nzi levels growing geometrically from
    2 m to ``depth``, clipped at each column's depth (state h's sum);
    returns (h_inc, the levels' centre depths) as tensors."""
    lo, hi = 1.0, 1.2
    for _ in range(60):             # the ratio that makes nzi levels
        r = 0.5 * (lo + hi)         # from 2 m sum to ``depth``
        if 2.0 * (r ** nzi - 1.0) / (r - 1.0) > depth:
            hi = r
        else:
            lo = r
    dz = torch.tensor([2.0 * r ** k for k in range(nzi)], dtype=st.h.dtype,
                      device=st.h.device)
    e = torch.cat([torch.zeros(1, dtype=dz.dtype, device=dz.device),
                   torch.cumsum(dz, 0)])
    col = st.h.sum(0)
    e = torch.minimum(e[:, None, None], col[None])
    e[-1] = col
    return torch.clamp(e[1:] - e[:-1], min=0.0), 0.5 * (e[1:] + e[:-1])


def _obs_error(T0, idx, truth0):
    """rms of T0 against the truth at the observed surface points."""
    i = torch.as_tensor(np.asarray(idx, np.int64), device=T0.device)
    d = T0.reshape(-1)[i].double() - truth0.reshape(-1)[i].double()
    return float(torch.sqrt((d * d).mean()))


def _oda_small_card_vs_cpu(dev, card):
    """eakf_update, oda_analysis and apply_oda_increments (16 levels with
    h_inc) on the small tripolar model in float64, card against CPU on
    the same members and observations, within SMALL_TOL of max-abs (T
    and S where the layer holds more than 1 mm of water: a vanished
    layer's remapped value is round-off over its 1e-10 m)."""
    from mom6_tpu_torch.parallel.ensemble import stack_ensemble
    from mom6_tpu_torch.physics.oda_driver import (ODAParams, oda_analysis,
                                                   synthetic_sst_obs)
    from mom6_tpu_torch.physics.oda_eakf import EAKFParams, eakf_update
    from mom6_tpu_torch.physics.oda_incupd import (IncrementalUpdate,
                                                   apply_oda_increments)
    out = {}
    for w in (dev, "cpu"):
        G, GV, st, p, f = _small_global(w)
        ens = stack_ensemble(_oda_members(st, G,
                                          np.random.default_rng(ODA_SEED)))
        idx, val, var = synthetic_sst_obs(st.T, G.mask2dT, 60, ODA_NOISE,
                                          seed=ODA_SEED)
        val = torch.tensor(val, dtype=torch.float64, device=w)
        var = torch.tensor(var, dtype=torch.float64, device=w)
        pe = EAKFParams(**ODA_EAKF)
        jj, ii = np.mgrid[0:G.ny, 0:G.nx]
        coords = torch.tensor(np.tile(np.stack([jj.ravel(), ii.ravel()], -1),
                                      (st.h.shape[0], 1)),
                              dtype=torch.float32, device=w)
        with torch.inference_mode():
            x = ens.T.reshape(ODA_NE, -1)
            eakf = eakf_update(x, idx, val, var, pe, coords=coords)
            inc, x_a = oda_analysis(ens, idx, val, var, G, ODAParams(eakf=pe))
            h_inc, zc = _inc_grid(st, G, nzi=16, depth=4000.0)
            dT = 0.5 * torch.exp(-zc / 300.0) * G.mask2dT
            s = apply_oda_increments(st, IncrementalUpdate(
                dT=dT, dS=0.1 * dT, h_inc=h_inc, ramp_seconds=7200.0),
                3600.0, G)
        wet = st.h > 1e-3
        out[w] = dict(eakf=eakf, analysis=inc.dT, x_a=x_a, T=s.T[wet],
                      S=s.S[wet])
    errs = {k: rel_err(v.cpu(), out["cpu"][k]) for k, v in out[dev].items()}
    log(f"[oda] card against CPU, float64, the 32x24x5 tripolar model, "
        f"{ODA_NE} members, 60 observations: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" of max-abs (tol {SMALL_TOL}); {card}")
    if not max(errs.values()) <= SMALL_TOL:
        raise AssertionError(f"[oda] card against CPU {errs}")


def _tides_and_filter(truth, G, dev, card):
    """HarmonicAnalysis of HA_NAMES on the (400, 720) grid and an
    HA_NAMES filter bank fed the truth's SSH plus known tidal maps,
    HA_SAMPLES hourly samples on the card: the maps recovered, an
    accumulate's time, and both against the same on the CPU."""
    from mom6_tpu_torch.diagnostics.harmonic_analysis import \
        HarmonicAnalysis
    from mom6_tpu_torch.diagnostics.streaming_filter import (filt_accum,
                                                             init_filter)
    from mom6_tpu_torch.physics.lateral.tidal_forcing import CONSTITUENTS
    rng = np.random.default_rng(ODA_SEED + 1)
    ny, nx = G.ny, G.nx
    yy, xx = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx),
                         indexing="ij")
    amp = np.stack([0.1 + 0.9 * (0.5 + 0.5 * np.sin(2 * np.pi * (
        xx + rng.uniform()) * (k + 1)) * np.cos(np.pi * yy))
        for k in range(len(HA_NAMES))])
    ph = np.stack([np.pi * np.sin(2 * np.pi * (yy + xx + rng.uniform()))
                   for _ in HA_NAMES])
    amp_t = torch.tensor(amp, device=G.mask2dT.device)
    ph_t = torch.tensor(ph, device=G.mask2dT.device)
    m = G.mask2dT.double()
    eta0 = find_eta(truth.h, G).double() * m
    om = [CONSTITUENTS[n].freq for n in HA_NAMES]
    runs = {}
    for w in (dev, "cpu"):
        ha = HarmonicAnalysis(HA_NAMES, (ny, nx))
        flt = init_filter(om, (ny, nx), alpha=0.05, dtype=torch.float32,
                          device=w)
        acc_ms = []
        for k in range(HA_SAMPLES):
            t = 3600.0 * k
            ssh = eta0 + sum(amp_t[i] * torch.cos(om[i] * t - ph_t[i])
                             for i in range(len(om))) * m
            ssh = ssh.to(w)
            if w == dev:
                torch.cuda.synchronize()
            t0 = time.time()
            ha.accumulate(t, ssh)
            if w == dev:
                torch.cuda.synchronize()
            acc_ms.append(1e3 * (time.time() - t0))
            flt = filt_accum(flt, ssh.float(), 3600.0)
        runs[w] = (ha, ha.solve(), flt, statistics.median(acc_ms))
    ha, sol, flt, acc = runs[dev]
    wet = (G.mask2dT > 0.5).cpu().numpy()
    a_err, p_err = [], []
    for i, n in enumerate(HA_NAMES):
        a_got, p_got = (x.cpu().numpy() for x in sol[n])
        a_err.append(float(np.abs(a_got - amp[i])[wet].max()))
        dp = np.angle(np.exp(1j * (p_got - ph[i])))
        p_err.append(float(np.abs(dp)[wet].max()))
    atb_same = bool(torch.equal(ha._atb.cpu(), runs["cpu"][0]._atb))
    sol_err = max(rel_err(sol[n][j].cpu(), runs["cpu"][1][n][j])
                  for n in HA_NAMES for j in (0, 1))
    flt_err = max(rel_err(getattr(flt, k).cpu(), getattr(runs["cpu"][2], k))
                  for k in ("s1", "u1"))
    log(f"[oda] HarmonicAnalysis{HA_NAMES} on ({ny}, {nx}), the truth's SSH "
        f"plus known tidal maps (0.1-1 m), {HA_SAMPLES} hourly samples on "
        f"the card: largest amplitude error "
        + ", ".join(f"{n} {e:.3e}" for n, e in zip(HA_NAMES, a_err))
        + " m, phase error " + ", ".join(f"{e:.3e}" for e in p_err)
        + f" rad (wet cells); an accumulate {acc:.3f} ms on the card "
        f"(median, host clock, synchronised; {runs['cpu'][3]:.3f} ms on the "
        f"host); against the CPU: the normal equations equal to the bit "
        f"{atb_same}, the solved maps {sol_err:.3e} of max-abs (tol "
        f"{SMALL_TOL}); the filter bank after {HA_SAMPLES} samples, float32, "
        f"{flt_err:.3e} of max-abs (tol 1e-6); {card}")
    if not (atb_same and sol_err <= SMALL_TOL and flt_err <= 1e-6
            and max(a_err) < 1e-3 and max(p_err) < 1e-2):
        raise AssertionError(f"[oda] harmonic analysis {a_err} {p_err} "
                             f"{atb_same} {sol_err}, filter {flt_err}")


def phase_oda(dev, ms_global, card):
    """``[oda]`` lines: the ensemble's data assimilation on
    configs/global_half_deg as committed (z*), f32 at 720x400x32: ODA_NE
    members (the state with a shared large-scale T bias and a spread of
    each member's own, from ODA_SEED), ODA_CYCLES analyses of ODA_OBS
    surface-T observations of a truth run (noise ODA_NOISE), the EAKF
    with ODA_EAKF, each followed by one thermo cycle of every member with
    its increments ramped over that cycle (launches exactly ODA_NE x
    ``fold_cycle(6)``) and one cycle of the truth: the EAKF's seconds,
    the ensemble mean's error at the observed points before and after,
    the increments zero on land; then one cycle with an external analysis
    on ODA_INC_LEVELS levels of its own (launches ``fold_cycle(6)`` plus
    2 remaps), whose remaps of dT and dS are captured and held bitwise
    (:func:`_check_remap_site`); the harmonic analysis and the filter
    (the small model card against CPU runs beside the gates,
    :func:`_oda_small_card_vs_cpu`).  Returns the launches of the
    members' cycles and the external cycle."""
    from mom6_tpu_torch.parallel.ensemble import (ensemble_step,
                                                  stack_ensemble)
    from mom6_tpu_torch.physics.oda_driver import (ODAParams, oda_analysis,
                                                   synthetic_sst_obs)
    from mom6_tpu_torch.physics.oda_eakf import EAKFParams
    from mom6_tpu_torch.physics.oda_incupd import (IncrementalUpdate,
                                                   apply_oda_increments)
    G, GV, p, f = ms_global.grid, ms_global.vgrid, ms_global.params, \
        ms_global.forcing
    dt_therm = p.dyn.dt * p.n_dyn_per_thermo
    truth = ms_global.state
    ens = stack_ensemble(_oda_members(truth, G,
                                      np.random.default_rng(ODA_SEED)))
    p_oda = ODAParams(eakf=EAKFParams(**ODA_EAKF), ramp_seconds=dt_therm)
    per = fold_cycle(p.n_dyn_per_thermo)
    land = (G.mask2dT < 0.5)

    def step(s):
        with torch.inference_mode():
            return step_mom(s, f, G, GV, p)

    def step_inc(s, dT):
        inc = IncrementalUpdate(dT=dT, ramp_seconds=dt_therm)
        with torch.inference_mode():
            return step_mom(s, f.replace(oda_inc=inc), G, GV, p)
    total = {k: 0 for k in per}
    for c in range(ODA_CYCLES):
        idx, val, var = synthetic_sst_obs(truth.T, G.mask2dT, ODA_OBS,
                                          ODA_NOISE, seed=ODA_SEED + c)
        prior = _obs_error(ens.T[:, 0].mean(0), idx, truth.T[0])
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            inc, x_a = oda_analysis(ens, idx, val, var, G, p_oda)
        torch.cuda.synchronize()
        secs = time.time() - t0
        post = _obs_error(x_a.mean(0)[:G.ny * G.nx], idx, truth.T[0])
        on_land = float(inc.dT[:, :, land].abs().max())
        before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        ens = ensemble_step(step_inc)(ens, inc.dT)
        torch.cuda.synchronize()
        fc_ms = 1e3 * (time.time() - t0)
        got = {k: n - before[k] for k, n in kernel_launches().items()}
        truth = step(truth)
        for k in total:
            total[k] += got[k]
        log(f"[oda] analysis {c + 1}: eakf_update at (ne, n) = ({ODA_NE}, "
            f"{x_a.shape[1]:,}) with {ODA_OBS} observations (noise "
            f"{ODA_NOISE} degC, inflation {ODA_EAKF['inflation']}, "
            f"localization {ODA_EAKF['loc_radius']} cells) in oda_analysis "
            f"{secs:.3f} s (host clock, synchronised); the ensemble mean's "
            f"surface-T error at the observed points {prior:.4f} -> "
            f"{post:.4f} degC; the increments' largest on land {on_land}; "
            f"the members' forecast cycle with the increments ramped over "
            f"it {fc_ms:.1f} wall ms, launches {got} (exactly {ODA_NE} x "
            f"fold_cycle({p.n_dyn_per_thermo})); {card}")
        if not (post < prior and on_land == 0.0
                and got == {k: ODA_NE * n for k, n in per.items()}):
            raise AssertionError(f"[oda] analysis {c + 1}: error {prior} -> "
                                 f"{post}, land {on_land}, launches {got}")
        if not bool(torch.isfinite(ens.T).all()):
            raise AssertionError("[oda] members' T not finite")
    st = ms_global.state
    h_inc, zc = _inc_grid(st, G)
    dT = 0.5 * torch.exp(-zc / 300.0) * G.mask2dT
    inc = IncrementalUpdate(dT=dT, dS=-0.05 * dT, h_inc=h_inc,
                            ramp_seconds=dt_therm)
    def step_inc_ext(s):
        with torch.inference_mode():
            return step_mom(s, f.replace(oda_inc=inc), G, GV, p)
    out = []
    before = kernel_launches()
    seen = _captured_remaps(lambda: out.append(step_inc_ext(st)))
    got = {k: n - before[k] for k, n in kernel_launches().items()}
    want = dict(per, remap=per["remap"] + 2)
    wet = G.mask2dT > 0.5
    with torch.inference_mode():
        dT_got = (apply_oda_increments(st, inc, dt_therm, G).T
                  - st.T)[:, wet]
    log(f"[oda] one cycle with an external analysis on {ODA_INC_LEVELS} "
        f"levels of its own (2 m growing to "
        f"{float(h_inc[:, wet].max()):.1f} m, clipped at each column's "
        f"depth): launches {got} (exactly fold_cycle("
        f"{p.n_dyn_per_thermo}) + 2 remaps, dT's and dS's); the increments "
        f"remapped onto the layers add {float(dT_got.min()):.4f} to "
        f"{float(dT_got.max()):.4f} degC to the wet T over the cycle; "
        f"{card}")
    if got != want or len(seen) != 5 or seen[0][1].shape[0] != \
            ODA_INC_LEVELS:
        raise AssertionError(f"[oda] external cycle: launches {got}, "
                             f"{len(seen)} remaps")
    _check_remap_site("oda", "the increments' PLM remap of dT", seen[0])
    _check_remap_site("oda", "the increments' PLM remap of dS", seen[1])
    for k in total:
        total[k] += got[k]
    del ens, out, seen
    torch.cuda.empty_cache()
    _tides_and_filter(truth, G, dev, card)
    return total

SOLO_OUT = os.path.join(OUT, "solo")
# the run directories of the idealized user cases: card against CPU
NEW_CONFIGS = ("dome2d_overflow", "dumbbell", "hurricane", "neverworld",
               "phillips_channel", "rossby_front", "scm_kpp", "seamount",
               "seasonal_gyre")
# split 2 + 2 against 4 straight thermo cycles; both runs write a stats
# line every cycle (tidal_bay takes its segment data at each stats
# segment's midpoint); tides_channel's restart carries En_itide
SPLIT_CONFIGS = ("rho_basin", "tracer_batch", "tidal_bay", "tides_channel")
N_SOLO_PROCS = 6            # CLI processes at once in the solo checks
# run directories whose free runs turn one differing last bit into a
# visible difference within two cycles (hycom_basin: PQM's bounds test and
# HYCOM1's interfaces switch on it; the card's float64 pow may part from
# the C library's, the CPU's, by an ulp): held to the CPU one cycle at a
# time from the CPU's state, each cycle to the same tolerances
CYCLE_BY_CYCLE = ("hycom_basin",)


def _solo_dir(name, sub, override="", files=()):
    """A fresh copy of configs/<name> (with its data files) and of
    ``files`` (paths in the checkout) under chip_smoke_out/solo
    (seasonal_gyre with its forcing file from the port's writer)."""
    import shutil
    from mom6_tpu_torch.drivers.user_cases import write_seasonal_forcing
    d = os.path.join(SOLO_OUT, sub, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(TREE, "configs", name), d)
    for f in files:
        shutil.copy(os.path.join(TREE, f), d)
    if name == "seasonal_gyre":
        write_seasonal_forcing(os.path.join(d, "forcing_monthly.nc"))
    if override:
        with open(os.path.join(d, "MOM_override"), "w") as f:
            f.write(override)
    return d


def _run_solo(runs, n_at_once=N_SOLO_PROCS):
    """Run each (run directory, CLI arguments) as users do,
    ``python -m mom6_tpu_torch.drivers.solo DIR ARGS``, n at a time; each
    must exit with 0.  Returns {run directory: seconds}."""
    todo, running, secs = list(runs), {}, {}
    while todo or running:
        while todo and len(running) < n_at_once:
            d, args = todo.pop(0)
            running[d] = _start_solo(d, args)
        for d, run in list(running.items()):
            if run[0].poll() is None:
                continue
            del running[d]
            try:
                secs[d] = _end_solo(d, run)
            except AssertionError:
                for other, run_o in running.items():
                    run_o[0].kill()
                    run_o[0].communicate()
                    run_o[2].close()
                raise
        time.sleep(0.2)
    return secs


def _start_solo(d, args, driver="solo"):
    """Start ``python -m mom6_tpu_torch.drivers.<driver> d args``; returns
    (process, start time, its log file)."""
    # one thread, at a lower priority: these runs fill the cores the
    # physics gates beside them leave idle, and the longest gate, a
    # host-bound single process, sets the end of the script
    env = dict(os.environ, PYTHONPATH=TREE, OMP_NUM_THREADS="1")
    log_f = open(os.path.join(d, "solo.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"mom6_tpu_torch.drivers.{driver}", d]
        + list(args), cwd=TREE, env=env, stdout=log_f,
        stderr=subprocess.STDOUT)
    os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
    return proc, time.time(), log_f


def _end_solo(d, run):
    """Wait for a run of :func:`_start_solo`; it must exit with 0.
    Returns its seconds."""
    proc, t0, log_f = run
    proc.wait()
    log_f.close()
    if proc.returncode != 0:
        with open(os.path.join(d, "solo.log")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"solo {d} exited with {proc.returncode}: "
                             f"{tail}")
    return time.time() - t0


def _solo_stats(d):
    """ocean.stats of a run directory as a list of {column: value}."""
    from mom6_tpu_torch.diagnostics.sum_output import read_stats
    return read_stats(os.path.join(d, "ocean.stats"))


def _solo_cputime(d):
    """(wall s, SYPD, {timer: s}, kernel launches) of ocean.cputime."""
    with open(os.path.join(d, "ocean.cputime")) as f:
        text = f.read()
    m = re.search(r"wall\s+([0-9.]+) s.*SYPD\s+([0-9.]+)", text)
    timers = {k.strip(): float(v) for k, v in re.findall(
        r"^\s*([a-z][a-z.+ ]+?)\s+([0-9.]+)s\s+\d+ calls", text, re.M)}
    launches = json.loads(text.split("kernel launches: ")[-1].splitlines()[0])
    return float(m.group(1)), float(m.group(2)), timers, launches


def phase_solo_global(dev, ms):
    """configs/global_half_deg as committed through the CLI for
    GLOBAL_CLI_DAYS (one ocean.stats line); the outputs; its restart
    restored at full shape; one stats call on the card both ways."""
    from mom6_tpu_torch.diagnostics.sum_output import compute_stats_device
    from mom6_tpu_torch.framework.restart import RestartRegistry
    from mom6_tpu_torch.io.netcdf import read_nc
    d = _solo_dir("global_half_deg", "global")
    secs = _run_solo([(d, ["--days", repr(GLOBAL_CLI_DAYS)])], 1)[d]
    G, GV, p = ms.grid, ms.vgrid, ms.params
    n = int(round(GLOBAL_CLI_DAYS * 86400.0
                  / (p.dyn.dt * p.n_dyn_per_thermo)))
    lines = _solo_stats(d)
    wall, sypd, timers, launches = _solo_cputime(d)
    log(f"[solo] python -m mom6_tpu_torch.drivers.solo global_half_deg "
        f"--days {GLOBAL_CLI_DAYS}: {n} thermo cycles, {len(lines)} "
        f"ocean.stats line(s), "
        f"process {secs:.1f} s; ocean.cputime: wall {wall:.2f} s, SYPD "
        f"{sypd:.2f}, {1e3 * wall / n:.1f} wall ms per cycle "
        f"({1e3 * timers.get('ocean dynamics+thermo', 0.0) / n:.1f} ms "
        f"stepping, {1e3 * timers.get('ocean.stats', 0.0):.1f} ms in "
        f"{len(lines)} stats call(s), "
        f"{1e3 * timers.get('diag mediator', 0.0):.1f} ms posting the "
        f"diagnostics); launches {launches}")
    s = lines[-1]
    if len(lines) != 1 or s["step"] != n:
        raise AssertionError(f"global ocean.stats: {lines}")
    if not all(math.isfinite(v) for v in s.values()):
        raise AssertionError(f"global ocean.stats not finite: {s}")
    if not abs(s["dM_net"]) < 1e-6 * s["Mass"]:
        raise AssertionError(f"global mass drift {s['dM_net']}")
    if not ("dS_net" in s and "dH_net" in s):
        raise AssertionError("no salt or heat drift column")
    for f in ("chksum_diag", "ocean.cputime", "ocean_diags.nc",
              "MOM_parameter_doc.all", "MOM_parameter_doc.short",
              os.path.join("RESTART", "ocean_solo.res")):
        if not os.path.exists(os.path.join(d, f)):
            raise AssertionError(f"no {f}")
    res = read_nc(os.path.join(d, "MOM.res.nc"))
    reg = RestartRegistry()
    names = reg.register_state(ms.state)
    for k in names:
        want = tuple(reg.get(k, ms.state).shape)
        if k not in res or res[k].shape != want:
            raise AssertionError(f"MOM.res.nc {k}: {res.get(k, None)}")
    diags = sorted(read_nc(os.path.join(d, "ocean_diags.nc")))
    log(f"[solo] MOM.res.nc holds {names} at full shape {GLOBAL_SHAPE}; "
        f"ocean_diags.nc holds {diags}")
    # the CLI's process builds with no kernel and steps n global cycles
    _check_counts(launches, PER_GLOBAL_CYCLE, n, "solo global_half_deg")
    # the restart on the card, and ocean.stats from it both ways
    st, t_s, _ = reg.restore_state(os.path.join(d, "MOM.res.nc"), ms.state)
    cp = p.diabatic.cp
    with torch.inference_mode():
        s_dev = compute_stats_device(st, G, GV, p.dyn.dt, cp=cp)
        t_dev = median_ms(lambda: compute_stats_device(st, G, GV, p.dyn.dt,
                                                      cp=cp), reps=5, warm=1)
        torch.cuda.synchronize()
        t0 = time.time()
        s_host = compute_stats(st, G, GV, p.dyn.dt, cp=cp)
        t_host = 1e3 * (time.time() - t0)
    for k, tag in (("mass", "Mass"), ("salt", "Salt"), ("heat", "Heat"),
                   ("KE", "KE"), ("APE", "APE")):
        tol = 1e-6 if k in ("KE", "APE") else 1e-11
        if abs(s_dev[k] - s[tag]) > tol * abs(s[tag]):
            raise AssertionError(f"{k}: restored {s_dev[k]} against the "
                                 f"CLI's {s[tag]}")
        if abs(s_dev[k] - s_host[k]) > 1e-5 * abs(s_host[k]):
            raise AssertionError(f"{k}: device {s_dev[k]} host {s_host[k]}")
    rel = {k: abs(s_dev[k] / s_host[k] - 1.0) for k in s_host if s_host[k]}
    log(f"[solo] the restart at t = {t_s:.0f} s on the card gives the CLI's "
        f"ocean.stats line again; one stats call at "
        f"{GLOBAL_SHAPE[2]}x{GLOBAL_SHAPE[1]}x{GLOBAL_SHAPE[0]}: on the card "
        f"(compute_stats_device, fixed-point sums) {t_dev:.2f} ms, on the "
        f"host (compute_stats, float64 reproducing sums) {t_host:.1f} ms; "
        f"relative differences {rel}")
    return launches


def _table_run(d, days, n_dyn, what):
    """Read a diag_table run of the CLI: its ocean.cputime, its launches
    held to its cycles and posts exactly, ocean_diags.nc's fields finite
    and diag_rejected.  Returns (wall s, SYPD, timers, launches, cycles,
    fields)."""
    from mom6_tpu_torch.io.netcdf import read_nc
    lines = _solo_stats(d)
    wall, sypd, timers, launches = _solo_cputime(d)
    n = lines[-1]["step"]
    posts = len(lines)
    want = {k: n * c + posts * table_post(n_dyn)[k]
            for k, c in fold_cycle(n_dyn).items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{n} cycles and {posts} posts: {want}")
    out = read_nc(os.path.join(d, "ocean_diags.nc"))
    fields = sorted(k for k in out if k.startswith("ocean_model_"))
    bad = [k for k in fields if not np.isfinite(out[k]).all()]
    if bad or len(fields) < 120:
        raise AssertionError(f"{what}: {len(fields)} fields, not finite "
                             f"{bad}")
    with open(os.path.join(d, "diag_rejected")) as f:
        rejected = [ln.split(":")[0] for ln in f.read().splitlines()]
    log(f"[table] {what} --days {days}: {n} thermo cycles, {posts} post(s); "
        f"ocean.cputime: wall {wall:.2f} s, SYPD {sypd:.2f}, "
        f"{1e3 * wall / n:.1f} wall ms per cycle "
        f"({1e3 * timers.get('ocean dynamics+thermo', 0.0) / n:.1f} ms "
        f"stepping, {1e3 * timers.get('diag mediator', 0.0) / posts:.1f} "
        f"ms a post); {len(fields)} fields in ocean_diags.nc, all finite; "
        f"rejected {rejected}; launches {launches} = {n} x "
        f"{fold_cycle(n_dyn)} + {posts} x {table_post(n_dyn)}")
    return wall, sypd, timers, launches, n, out


def _post_breakdown(ms, d):
    """One post of the table in this process on the state the CLI's day
    ended with (its MOM.res.nc): the launches of one post, held to
    PER_TABLE_POST, and the device-synchronised host time of the post and
    of its parts."""
    from mom6_tpu_torch.diagnostics import wave_speed as ws
    from mom6_tpu_torch.diagnostics.catalog import DiagContext, serve
    from mom6_tpu_torch.drivers import solo as solo_mod
    from mom6_tpu_torch.framework.diag_mediator import DiagMediator
    from mom6_tpu_torch.framework.restart import RestartRegistry
    G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing
    reg = RestartRegistry()
    reg.register_state(ms.state)
    st, _, _ = reg.restore_state(os.path.join(d, "MOM.res.nc"), ms.state)
    eos = get_eos(p.eos_name)
    ke_fn = solo_mod.make_ke_budget_fn(G, GV, p)
    tend_fn = solo_mod.make_tend_fn(G, GV, p)

    def post():
        dm = DiagMediator.from_diag_table(
            os.path.join(d, "diag_table"),
            z_targets=np.asarray(p.ale.dz_nominal),
            rho_targets=GV.Rlay.cpu().numpy().astype(np.float64),
            nz_sigma=GV.nz, areaT=G.areaT.cpu().numpy(), device=st.h.device)
        solo_mod._post_table_diags(dm, st, G, GV, p, f, ke_fn, tend_fn)

    def secs(fn, n=1):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    with torch.inference_mode():
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post()
        torch.cuda.synchronize()
        t_post = 1e3 * (time.perf_counter() - t0)
        counts = kernel_launches()
        _check_counts(counts, PER_TABLE_POST, 1, "one table post")
        parts = {
            "post (the first)": [t_post],
            "KE budget (a split step)": secs(lambda: ke_fn(st, f)),
            "tendencies (a thermo cycle)": secs(lambda: tend_fn(st, f)),
            "wave_speed (10 solves)": secs(lambda: ws.wave_speed(
                st.h, st.T, st.S, G, GV, eos)),
        }

        def rest():
            # the KE budget, the tendencies and cg1 as computed
            ctx = DiagContext(st, G, GV, p, forcing=f, eos=eos)
            ctx._cache.update(ke_terms={}, tend={}, cg1=st.h[0])
            for name in names:
                serve(name, ctx)
        names = cat_names(d)
        parts["the other fields, on the card"] = secs(rest)
    log(f"[table] one post at {GV.nz}x{G.ny}x{G.nx} in this process, on "
        f"the state after the CLI's day: launches {counts} (= "
        f"PER_TABLE_POST); host ms with the device synchronised, the "
        f"parts one call each after a warm one: " + "; ".join(
            f"{k} {', '.join(f'{v:.1f}' for v in vs)}"
            for k, vs in parts.items()))
    return counts, parts


def cat_names(d):
    """The catalog names of a run directory's diag_table fields."""
    from mom6_tpu_torch.drivers.solo import _base_name
    from mom6_tpu_torch.framework.diag_mediator import parse_diag_table
    return sorted({_base_name(f[1]) for f in parse_diag_table(
        os.path.join(d, "diag_table")).fields})


def phase_solo_table(dev, ms):
    """The diag_table path of the CLI, timed alone: configs/global_half_deg
    with global_2deg's diag_table for GLOBAL_CLI_DAYS (one post, f32,
    720x400x32) and configs/global_2deg as committed for TABLE_2DEG_DAYS
    in float64 (12 cycles, one post), each in its own process; then one
    post in this process, its launches and its parts.  Returns the
    launches of the two runs."""
    table = (os.path.join("configs", "global_2deg", "diag_table"),)
    d_half = _solo_dir("global_half_deg", "table", files=table)
    d_2deg = _solo_dir("global_2deg", "card", "DOUBLE_PRECISION = True\n")
    secs = _run_solo([(d_half, ["--days", repr(GLOBAL_CLI_DAYS)])], 1)
    secs.update(_run_solo([(d_2deg, ["--days", repr(TABLE_2DEG_DAYS)])],
                          1))
    out = {}
    for d, n_dyn, what in ((d_half, 6, "global_half_deg with the table "
                            "f32"), (d_2deg, 2, "global_2deg f64 on the "
                                     "card")):
        out[d] = _table_run(d, GLOBAL_CLI_DAYS if d == d_half
                            else TABLE_2DEG_DAYS, n_dyn, what)
        log(f"[table] {what}: process {secs[d]:.1f} s")
    _post_breakdown(ms, d_half)
    return {"solo_table_global_half_deg": out[d_half][3],
            "solo_table_global_2deg": out[d_2deg][3]}


def _diag_differences(a, b, table, h_wet=1e-3):
    """Each ocean_model_ field's largest difference between two
    ocean_diags.nc contents written for the diag_table ``table``,
    relative to its max-abs in ``b``: on the layers where ``b``'s layer
    holds water (u, v and corner fields where the mean of the two
    neighbours does), at the interfaces where a layer on either side
    does."""
    from mom6_tpu_torch.diagnostics.catalog import CATALOG
    from mom6_tpu_torch.drivers.solo import _base_name
    from mom6_tpu_torch.framework.diag_mediator import parse_diag_table
    field_of = {f"ocean_model_{out}": fld
                for _, fld, out, _, _ in parse_diag_table(table).fields}
    h = np.asarray(b["ocean_model_h"], np.float64)
    wet = {"h": h > h_wet,
           "u": 0.5 * (h + np.roll(h, -1, -1)) > h_wet,
           "v": 0.5 * (h + np.roll(h, -1, -2)) > h_wet}
    wet["q"] = wet["u"] & wet["v"]
    w_lay = h > h_wet
    w_int = np.zeros((h.shape[0] + 1,) + h.shape[1:], bool)
    w_int[:-1] |= w_lay
    w_int[1:] |= w_lay
    out = {}
    for k in sorted(b):
        if not k.startswith("ocean_model_"):
            continue
        w = np.asarray(b[k], np.float64)
        diff = np.abs(np.asarray(a[k], np.float64) - w)
        stagger = CATALOG[_base_name(field_of[k])].stagger
        if w.shape == h.shape:
            diff = diff * wet.get(stagger, wet["h"])
        elif w.shape == w_int.shape:
            diff = diff * w_int
        out[k[len("ocean_model_"):]] = float(
            diff.max() / max(np.abs(w).max(), 1e-300))
    return out


def start_table_cpu():
    """Start configs/global_2deg for TABLE_2DEG_DAYS in float64 on the CPU
    (--device cpu), the reference of phase_solo_table_cpu."""
    cpu = _solo_dir("global_2deg", "cpu", "DOUBLE_PRECISION = True\n")
    return cpu, _start_solo(cpu, ["--days", repr(TABLE_2DEG_DAYS),
                                  "--device", "cpu"])


def phase_solo_table_cpu(started):
    """The CPU's run of configs/global_2deg (``started`` by
    start_table_cpu) against the card's of phase_solo_table: the same
    fields and rejections, ocean.stats to the golden tolerances and every
    field of ocean_diags.nc within 1e-10 of its max-abs (on the layers
    and faces that hold water)."""
    from mom6_tpu_torch.io.netcdf import read_nc
    card = os.path.join(SOLO_OUT, "card", "global_2deg")
    cpu, run = started
    secs = _end_solo(cpu, run)
    a = read_nc(os.path.join(card, "ocean_diags.nc"))
    b = read_nc(os.path.join(cpu, "ocean_diags.nc"))
    if sorted(a) != sorted(b):
        raise AssertionError("global_2deg: card and CPU wrote other fields")
    with open(os.path.join(card, "diag_rejected")) as fa, \
            open(os.path.join(cpu, "diag_rejected")) as fb:
        if fa.read() != fb.read():
            raise AssertionError("global_2deg: other rejections")
    errs = {}
    for ra, rb in zip(_solo_stats(card), _solo_stats(cpu)):
        for k in ("Mass", "Salt", "Heat", "KE", "APE"):
            errs[k] = abs(ra[k] - rb[k]) / max(abs(rb[k]), 1e-300)
    fields = _diag_differences(a, b, os.path.join(cpu, "diag_table"))
    worst = sorted(fields.items(), key=lambda kv: -kv[1])
    log(f"[table] global_2deg f64 --days {TABLE_2DEG_DAYS}, card against CPU "
        f"({secs:.1f} s on the CPU with its process): ocean.stats relative "
        f"differences {errs}; {len(fields)} fields of ocean_diags.nc, the "
        f"largest relative differences (of max-abs, where water) "
        f"{worst[:8]}; all: {fields}")
    bad = {k: e for k, e in errs.items()
           if e > (1e-9 if k in ("KE", "APE") else 1e-12)}
    bad.update({k: e for k, e in fields.items() if not e <= 1e-10})
    if bad:
        raise AssertionError(f"global_2deg card against CPU: {bad}")
    return fields


def _cycle_days(name, n):
    """``n`` thermo cycles of configs/<name> in days, as the CLI's --days
    argument."""
    pf = ParamFile([os.path.join(TREE, "configs", name, "MOM_input")])
    dt = pf.get("DT", float)
    return repr(n * pf.get("DT_THERM", float, default=dt) / 86400.0)


def _card_against_cpu(what, card, cpu):
    """The card's run directory against the CPU's: the relative
    differences of every ocean.stats line the card wrote (against the
    CPU's last as many lines: a run from a restart counts its steps from
    its start; mass, heat, salt within 1e-12, KE, APE
    within 1e-9) and the largest of the restart fields' (1e-10 of
    max-abs).  Any miss raises."""
    from mom6_tpu_torch.framework.restart import restart_differences
    a, b = _solo_stats(card), _solo_stats(cpu)
    if not a or len(a) > len(b):
        raise AssertionError(f"{what}: {a} {b}")
    errs = {}
    for ra, rb in zip(a, b[len(b) - len(a):]):
        for k in ("Mass", "Salt", "Heat", "KE", "APE"):
            if k in rb:
                errs[k] = max(errs.get(k, 0.0), abs(ra[k] - rb[k])
                              / max(abs(rb[k]), 1e-300))
    for k, e in errs.items():
        if e > (1e-9 if k in ("KE", "APE") else 1e-12):
            raise AssertionError(f"{what} card against CPU: {k} {e}")
    errs["fields"] = max(restart_differences(
        os.path.join(card, "MOM.res.nc"),
        os.path.join(cpu, "MOM.res.nc")).values())
    if errs["fields"] > 1e-10:
        raise AssertionError(f"{what} card against CPU: restart fields "
                             f"{errs['fields']}")
    return errs


def phase_solo_runs(dev):
    """The split runs (rho_basin, tracer_batch and tidal_bay in float64,
    2 + 2 against 4 straight cycles, on the card), the nine new run
    directories, the six with open boundaries and the six of the sponge,
    the BBL, REENTRANT_Y, LF17, the bulk mixed layer and HYCOM1 for 2
    cycles in float64 on the card and on the CPU (CYCLE_BY_CYCLE one
    cycle at a time from the CPU's state), and seasonal_gyre for half a
    day in float32 through its forcing file."""
    from mom6_tpu_torch.io.netcdf import read_nc
    f64 = "DOUBLE_PRECISION = True\n"
    first = []
    split_ov = {n: f"{f64}ENERGYSAVEDAYS = {_cycle_days(n, 1)}\n"
                for n in SPLIT_CONFIGS}
    for name in SPLIT_CONFIGS:
        ov = split_ov[name]
        first += [(_solo_dir(name, "straight", ov),
                   ["--days", _cycle_days(name, 4)]),
                  (_solo_dir(name, "first", ov),
                   ["--days", _cycle_days(name, 2)])]
    pairs, stepwise = {}, {}
    for name in NEW_CONFIGS + tuple(OBC_CONFIGS) + tuple(RUNDIR_CONFIGS):
        days = _cycle_days(name, 2)
        if name in CYCLE_BY_CYCLE:
            # the CPU's 2 cycles and its first; the card's first, then
            # its second from the CPU's first (a stats line a cycle)
            ov = f"{f64}ENERGYSAVEDAYS = {_cycle_days(name, 1)}\n"
            one = _cycle_days(name, 1)
            card, cpu1, cpu = (_solo_dir(name, sub, ov)
                               for sub in ("card", "cpu1", "cpu"))
            stepwise[name] = (card, cpu1, cpu, ov)
            first += [(card, ["--days", one]),
                      (cpu1, ["--days", one, "--device", "cpu"]),
                      (cpu, ["--days", days, "--device", "cpu"])]
            continue
        card = _solo_dir(name, "card", f64)
        cpu = _solo_dir(name, "cpu", f64)
        pairs[name] = (card, cpu)
        first += [(card, ["--days", days]),
                  (cpu, ["--days", days, "--device", "cpu"])]
    sg = _solo_dir("seasonal_gyre", "f32", "ENERGYSAVEDAYS = 0.125\n")
    first.append((sg, ["--days", "0.5"]))
    secs = _run_solo(first)
    second = []

    def after(name, sub, prev, ov, days):
        d = _solo_dir(name, sub, ov)
        import shutil
        shutil.copy(os.path.join(prev, "RESTART", "ocean_solo.res"), d)
        second.append((d, ["--days", days, "--restart-in",
                           os.path.join(prev, "MOM.res.nc")]))
        return d
    for name in SPLIT_CONFIGS:
        after(name, "second", os.path.join(SOLO_OUT, "first", name),
              split_ov[name], _cycle_days(name, 2))
    card2 = {name: after(name, "card2", cpu1, ov, _cycle_days(name, 1))
             for name, (_, cpu1, _, ov) in stepwise.items()}
    secs.update(_run_solo(second))
    for name in SPLIT_CONFIGS:
        a = read_nc(os.path.join(SOLO_OUT, "straight", name, "MOM.res.nc"))
        b = read_nc(os.path.join(SOLO_OUT, "second", name, "MOM.res.nc"))
        diff = [k for k in a if k != "__step__"
                and not np.array_equal(a[k], b.get(k))]
        if diff or sorted(a) != sorted(b):
            raise AssertionError(f"split {name}: {diff}")
        if name == "tides_channel" and not (
                "En_itide" in a and np.abs(a["En_itide"]).max() > 0.0):
            raise AssertionError("split tides_channel: no En_itide")
        log(f"[solo] {name} f64 on the card: 2 + 2 cycles (--restart-in) "
            f"equal 4 straight cycles to the bit in all {len(a) - 2} "
            f"restart fields")
    worst = {}
    for name, (card, cpu1, cpu, _) in stepwise.items():
        # cycle 1 from the same start, cycle 2 from the CPU's first
        errs = [_card_against_cpu(f"{name} cycle {c}", a, b)
                for c, (a, b) in enumerate(((card, cpu1), (card2[name], cpu)),
                                           1)]
        worst[name] = {k: max(e[k] for e in errs) for k in errs[0]}
        log(f"[solo] {name} f64 through the CLI, card against CPU one "
            f"cycle at a time from the CPU's state: relative differences "
            f"of ocean.stats and of the restart fields (of max-abs; T, S "
            f"where a layer holds water, u, v on faces that do), cycle 1 "
            f"{errs[0]}, cycle 2 {errs[1]}; {secs[card]:.1f} + "
            f"{secs[card2[name]]:.1f} s on the card, {secs[cpu]:.1f} s on "
            f"the CPU (each with its process); ocean.cputime on the card: "
            f"{1e3 * _solo_cputime(card)[0]:.1f} wall ms for the first "
            f"cycle (beside the gates)")
    for name, (card, cpu) in pairs.items():
        errs = _card_against_cpu(name, card, cpu)
        worst[name] = errs
        extra = ""
        if name in OBC_CONFIGS or name in RUNDIR_CONFIGS:
            wall = _solo_cputime(card)[0]
            extra = (f"; ocean.cputime on the card: {1e3 * wall / 2:.1f} "
                     f"wall ms per cycle (beside the gates)")
        log(f"[solo] {name} f64, 2 cycles through the CLI, card against "
            f"CPU: relative differences of ocean.stats and of the restart "
            f"fields (of max-abs; T, S where a layer holds water, u, v on "
            f"faces that do) {errs}; "
            f"{secs[card]:.1f} s on the card, {secs[cpu]:.1f} s on the CPU "
            f"(each with its process){extra}")
    lines = _solo_stats(sg)
    if len(lines) != 4 or not all(math.isfinite(v) for r in lines
                                  for v in r.values()):
        raise AssertionError(f"seasonal_gyre f32: {lines}")
    ms = build_model_from_params(ParamFile([os.path.join(sg, "MOM_input"),
                                            os.path.join(sg, "MOM_override")]),
                                 device=dev)
    dt_seg = 0.125 * 86400.0
    taux = [ms.forcing_provider((c + 0.5) * dt_seg).mech.taux
            for c in range(4)]
    change = [float((taux[c + 1] - taux[c]).abs().max()) for c in range(3)]
    if not all(x > 0.0 for x in change):
        raise AssertionError(f"seasonal_gyre: the wind does not change "
                             f"{change}")
    log(f"[solo] seasonal_gyre f32 --days 0.5 through forcing_monthly.nc: "
        f"{len(lines)} ocean.stats lines, finite, mass drift "
        f"{lines[-1]['dM_net']:.3e} of {lines[-1]['Mass']:.6e} kg; the wind "
        f"at the segments' midpoints changes by {change} Pa from segment to "
        f"segment; {secs[sg]:.1f} s")
    return worst


# the gates by their CPU time, longest first (tests/test_torch_analytic.py;
# the twin experiment ~150 s, HOST_GATES)
GATE_ORDER = ("kpp_convective_deepening",
              "phillips_baroclinic_instability_growth",
              "twin_experiment_reduces_error",
              "dome_plume_turns_west", "tidal_bay_file_forcing",
              "hurricane_cold_wake", "kelvin_wave_trapped_at_coast",
              "epbl_convective_deepening", "lock_exchange_benjamin_front",
              "ekman_spiral_finite_depth", "stommel_gyre_sverdrup_balance")


# the gates of neutral diffusion, ADAPTIVE, the internal tides, the tidal
# mixing, the wave drag and the spherical gyre, of the coupled caps, of
# the step's shared options and of the lateral options: each a second or
# less on the card, so they run GATE_BATCH to a process (27: five
# processes for the 135; a gate process takes ~20-25 s to start, and with
# ten a process the pool's 51 processes spent ~1,200 of its ~2,500
# process-seconds starting)
GATE_BATCH = 27
# the gates that are neither of GATE_ORDER (the longest, alone) nor
# batched above: 10-70 s each on the card, MEDIUM_BATCH to a process
MEDIUM_BATCH = 4


def _gate_jobs(names):
    """The gates as jobs, one process each: those of GATE_ORDER (the
    longest) alone, the others in groups of MEDIUM_BATCH, those of
    torch_gates.BATCHED in groups of GATE_BATCH."""
    import torch_gates
    batched = [n for n in names if n in getattr(torch_gates, "BATCHED", ())]
    medium = [n for n in names if n not in batched and n not in GATE_ORDER]
    jobs = [[n] for n in names if n in GATE_ORDER]
    jobs += [medium[i:i + MEDIUM_BATCH]
             for i in range(0, len(medium), MEDIUM_BATCH)]
    jobs += [batched[i:i + GATE_BATCH]
             for i in range(0, len(batched), GATE_BATCH)]
    return jobs


def start_gates():
    """The physics gates in processes of their own on the card
    (``--gate``), N_GATE_PROCS at a time, the longest first, started by a
    thread; returns the pool for :func:`phase_physics` and
    :func:`stop_gates`."""
    import torch_gates
    names = list(GATE_ORDER) + [g for g in torch_gates.GATES
                                if g not in GATE_ORDER]
    pool = {"todo": _gate_jobs(names), "running": {}, "done": {},
            "t0": time.time(), "lock": threading.Lock()}
    pool["thread"] = threading.Thread(target=_pump_gates, args=(pool,),
                                      daemon=True)
    pool["thread"].start()
    return pool


def _pump_gates(pool):
    """Keep N_GATE_PROCS gate processes running until every job has
    ended."""
    while True:
        with pool["lock"]:
            for job, (proc, t0) in list(pool["running"].items()):
                if proc.poll() is not None:
                    out, err = proc.communicate()
                    pool["done"][job] = (proc.returncode, out, err,
                                         time.time() - t0)
                    del pool["running"][job]
            while pool["todo"] and len(pool["running"]) < N_GATE_PROCS:
                job = ",".join(pool["todo"].pop(0))
                cmd = [sys.executable, os.path.abspath(__file__), "--gate",
                       job] + (["--tree", TREE] if TREE != REPO else [])
                pool["running"][job] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), time.time())
            if not pool["running"]:
                return
        time.sleep(0.5)


def stop_gates(pool):
    """End every gate process still running (after a failure)."""
    with pool["lock"]:
        pool["todo"] = []
        for proc, _ in pool["running"].values():
            proc.kill()
            proc.communicate()
        pool["running"] = {}


def phase_physics(pool):
    """Wait for every gate; one line per case; any miss raises.  Returns
    the launch counts summed over the gates."""
    pool["thread"].join()
    counts = {k: 0 for k in kernel_launches()}
    failed = []
    import torch_gates
    recs, procs = {}, {}
    for job, (rc, out, err, secs) in pool["done"].items():
        for ln in out.splitlines():
            if ln.startswith("GATE "):
                rec = json.loads(ln[5:])
                recs[rec["name"]] = rec
        for name in job.split(","):
            procs[name] = (rc, err, secs, len(job.split(",")))
    for name in torch_gates.GATES:
        rc, err, secs, n_job = procs[name]
        rec = recs.get(name)
        if rec is None or not rec.get("passed"):
            log(f"[physics] {name}: FAILED ({secs:.1f} s): "
                f"{rec and rec.get('error_text')} {err[-2000:]}")
            failed.append(name)
            continue
        r = rec["record"]
        extra = {k: v for k, v in r.items() if k not in (
            "quantity", "measured", "analytic", "error", "gate", "seconds")}
        with_proc = (f"{secs:.1f} s with its process" if n_job == 1 else
                     f"{secs:.1f} s for the process of {n_job} gates")
        where = "the card" if r.get("device", "cuda") == "cuda" else \
            "the host's CPU (HOST_GATES)"
        extra.pop("device", None)
        log(f"[physics] {name}: {r['quantity']} {r['measured']:.6g} against "
            f"{r['analytic']:.6g} analytic, error {r['error']:+.4g}; gate "
            f"{r['gate']}: passed; {r['seconds']:.1f} s on {where} "
            f"({with_proc})" + (f"; {extra}" if extra else ""))
        for k in counts:
            counts[k] += rec["counts"][k]
    log(f"[physics] {len(torch_gates.GATES)} gates in "
        f"{time.time() - pool['t0']:.1f} s, {N_GATE_PROCS} processes at a "
        f"time; launches summed over the gates {counts}")
    if failed:
        raise AssertionError(f"physics gates failed: {failed}")
    return counts


# ---------------------------------------------------------------------------
# [mesh]: the global model on ranks (parallel/mesh.py)
# ---------------------------------------------------------------------------

# the layouts of the half-degree cycle on gloo ranks that share cuda:0: the
# 2x2 mesh (tiles of 200x360) and the 1x2 mesh (400x360)
MESH_LAYOUTS = ((2, 2), (1, 2))
MESH_RANKS = 4
# the ensemble over ranks: four double-gyre members at SLICE's size, one
# on each rank, told apart by their winds
MESH_ENSEMBLE = 4
# the kernels' tile forms that the ranks capture from the 2x2 cycle and
# check: rank 0 (the bottom-left tile, on the fold grid's bottom rank row)
# all of them, rank 2 (the top-left tile, under the fold) those that
# differ there: the HALO form without the fold image row, the y flux
# under the fold's ghost row
MESH_CHECKERS = {0: None, 2: ("halo", "merid_flux")}
MESH_FIELDS = ("h", "u", "v", "T", "S")
# the half-degree model's options on ranks: the harmonic SAL beside the
# scalar one, SPPT and SKEB (TIDES needs a spherical grid in the port as in
# the reference, and the Stanley quadrature, 1688 device ms a cycle,
# stays off); the one-rank cycle runs with the same options
MESH_OVERRIDE = ("SAL_SCALAR_VALUE = 0.094\nSAL_HARMONICS = True\n"
                 "DO_SPPT = True\nDO_SKEB = True\n")
# the configurations held on the 1x2 mesh for one cycle each, as committed:
# DOME's open boundary (SPECIFIED inflow) and ISOMIP's ice shelf
MESH_SMALL = ("dome", "isomip")
# with --mesh the cycles and the tile forms run under the profiler (each
# rank's process takes the flag from its arguments)
MESH_PROFILE = "--mesh" in sys.argv


def _capture_tile_launches():
    """Wrap the kernels' launch functions so that the first launch of each
    form and shape keeps a copy of its inputs: {(form, shape): args}.
    Returns (seen, undo)."""
    seen = {}
    saved = []

    def wrap(module, attr, form_of):
        orig = getattr(module, attr)

        def record(*args):
            key = form_of(*args)
            if key is not None and key not in seen:
                seen[key] = [a.clone() if torch.is_tensor(a) else a
                             for a in args]
            return orig(*args)
        setattr(module, attr, record)
        saved.append((module, attr, orig))

    wrap(cppm, "_edges_launch",
         lambda name, h, *a: (f"{name} tile", tuple(h.shape)))
    wrap(cppm, "_edges_halo_launch",
         lambda name, hp, mp, ny, h_min, mono, s2, fold:
         (f"halo fold={int(fold)}", tuple(hp.shape)))
    wrap(cppm, "_flux_launch",
         lambda name, h, *a: (f"{name} tile", tuple(h.shape)))
    wrap(remap, "_remap_launch",
         lambda coef, *a: ("remap tile", tuple(coef.shape)))

    def undo():
        for module, attr, orig in saved:
            setattr(module, attr, orig)
    return seen, undo


def _tile_row(label, shape, pairs, nbytes, nflops, kernel_name):
    """A tile form's row: each (kernel, plain) of ``pairs`` 0 ulps apart
    in every output, the first pair timed (the kernel from an idle
    device, 20 calls; its plain version PLAIN_REPS calls).  Its device
    ms (the profiler's, in the kernels whose name holds ``kernel_name``)
    only with ``--mesh``: the trace costs seconds a form with the four
    ranks' processes up, so a whole run leaves it null."""
    err = 0.0
    for kernel, plain in pairs:
        for k, p in zip(kernel(), plain()):
            ul = max_ulps(k, p)
            if ul != 0:
                raise AssertionError(f"[mesh] {label} {shape}: {ul} ulps")
            err = max(err, float((k - p).abs().max()))
    ms = median_ms(pairs[0][0])
    d_ms = device_ms(pairs[0][0], kernel_name) if MESH_PROFILE else None
    pms = median_ms(pairs[0][1], PLAIN_REPS, warm=1)
    row = _kernel_row(err, ms, d_ms, pms, nbytes, nflops, shape)
    dev = "" if d_ms is None else f", device {d_ms:.4f} ms"
    log(f"[mesh] {label} {shape}: {len(pairs)} forms 0 ulps; kernel "
        f"{ms:.4f} ms{dev}, plain {pms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def _check_tile_forms(seen, rank):
    """Each captured tile form against its plain version at the same
    inputs (0 ulps), timed: {(row name, shape): row}."""
    rows = {}
    for (form, shape), args in sorted(seen.items(), key=str):
        if form.startswith("halo") or form.endswith("edges tile"):
            if form.startswith("halo"):
                name, hp, mp, ny, h_min, _, _, fold = args
                key, out = "ppm_edges_y_halo", (hp.shape[0], ny,
                                                hp.shape[2])
                label = f"{key} (rank {rank}, fold image row {bool(fold)})"
                kern = lambda mono, s2: cppm._edges_halo_launch(  # noqa
                    name, hp, mp, ny, h_min, mono, s2, fold)
                plain = lambda mono, s2: cppm.ppm_edges_halo_plain(  # noqa
                    hp, mp, h_min, mono, s2, fold)
            else:
                name, hp, mp, h_min, _, _, direction = args[:7]
                fold = bool(args[7]) if len(args) > 7 else False
                if direction == cppm._DIR_X:
                    key, where = "ppm_edges_x", "halo columns"
                else:
                    key = "ppm_edges_y_fold" if fold else "ppm_edges_y"
                    where = "its rows whole"
                out = tuple(hp.shape)
                label = f"{key} tile (rank {rank}, {where})"
                kern = lambda mono, s2: cppm._edges_launch(  # noqa
                    name, hp, mp, h_min, mono, s2, direction, fold)
                plain = lambda mono, s2: cppm.ppm_edges_plain(  # noqa
                    hp, mp, h_min, mono, s2, direction, fold)
            n, plane = math.prod(out), out[1] * out[2]
            rows[(key, out)] = _tile_row(
                label, out, [(functools.partial(kern, mono, s2),
                              functools.partial(plain, mono, s2))
                             for _, mono, s2 in LIMITERS],
                4 * (3 * n + plane), FLOPS_PER_POINT["ppm_edges"] * n,
                "ppm_edges")
        elif "flux" in form:
            name, h, hl, hr, face, d_p, d_m, u = args[:8]
            direction = args[10]
            fold = bool(args[11]) if len(args) > 11 else False
            key = "ppm_flux_x" if direction == cppm._DIR_X else (
                "ppm_flux_y_fold" if fold else "ppm_flux_y")
            g = torch.Generator(device=u.device).manual_seed(5)
            dw = 0.05 * torch.randn(u.shape[1:], generator=g,
                                    device=u.device, dtype=u.dtype)
            rem = torch.rand(u.shape, generator=g, device=u.device,
                             dtype=u.dtype)
            pairs = [(functools.partial(cppm._flux_launch, name, h, hl, hr,
                                        face, d_p, d_m, u, a, b, direction,
                                        fold),
                      functools.partial(cppm.ppm_flux_plain, h, hl, hr, face,
                                        d_p, d_m, u, a, b, direction, fold))
                     for a, b in ((dw, rem), (None, None))]
            n, plane = math.prod(shape), shape[1] * shape[2]
            rows[(key, shape)] = _tile_row(
                f"{key} tile (rank {rank})", shape,
                pairs, 4 * (7 * n + 4 * plane),
                FLOPS_PER_POINT["ppm_flux"] * n, "ppm_flux_kernel")
        elif form == "remap tile":
            coef, h0, h1, lo, hi = args
            nf, npoly, nz0 = coef.shape[0], coef.shape[1], coef.shape[2]
            n_bytes, n_ops = _remap_work(nf, npoly, nz0, h1.shape[0],
                                         h0.shape[1] * h0.shape[2])
            rows[("remap", tuple(coef.shape))] = _tile_row(
                f"remap tile (rank {rank}, nf={nf})", tuple(coef.shape),
                [(lambda: [remap._remap_launch(coef, h0, h1, lo, hi)],
                  lambda: [remap.remap_integrals_plain(coef, h0, h1, lo,
                                                       hi)])],
                n_bytes, n_ops, "remap_kernel")
    return rows


def _check_tile_tridiag(a, b, c, d, rank):
    """The Thomas kernel at a tile shape of the cycle against its plain
    version (0 ulps), timed."""
    n = d.numel()
    return _tile_row(f"tridiag tile (rank {rank})", tuple(d.shape),
                     [(lambda: [solvers.tridiag_solve(a, b, c, d)],
                       lambda: [solvers.tridiag_solve_plain(a, b, c, d)])],
                     4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n,
                     "thomas_kernel")


def _capture_solves():
    """Wrap the cycle's tridiag_solve users so that the first solve keeps
    a copy of its (a, b, c, d).  Returns (solves, undo)."""
    solves = []
    orig = solvers.tridiag_solve

    def keep_solve(a, b, c, d):
        if not solves:
            solves.append([t.clone() for t in (a, b, c, d)])
        return orig(a, b, c, d)
    users = _solve_users()
    for mod in users:
        mod.tridiag_solve = keep_solve

    def undo():
        for mod in users:
            mod.tridiag_solve = orig
    return solves, undo


def _card_busy(fn):
    """(``fn()``, NVML's utilization.gpu in percent while it ran): the mean
    of the share of each sample period in which a kernel ran, sampled
    every 100 ms by nvidia-smi; None where no sample came.  A period with
    any kernel counts whole, so it overstates the busy share of short
    kernels: it is not the profiler's idle share.  The profiler's trace of
    a ~93,600-kernel cycle costs ~10 s of host time (38.8 s for the four
    gloo ranks' cycle), the sampler none."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)                 # its first sample
        out = fn()
    finally:
        smi.terminate()
        text = smi.communicate(timeout=30)[0]
    vals = [float(v) for v in text.split() if v.replace(".", "").isdigit()]
    return out, (statistics.mean(vals) if vals else None)


def _card_use(run, sample=True):
    """(``run()``, what the card did while it ran): with ``--mesh`` this
    process's device ms from the profiler (``device_ms``,
    :func:`_device_activity`); else, where ``sample``, NVML's sampled
    utilization.gpu (``nvml_busy``, :func:`_card_busy`)."""
    if MESH_PROFILE:
        res = []
        dev_ns = _device_activity(lambda: res.append(run()))[0]
        return res[0], dict(device_ms=dev_ns / 1e6)
    if sample:
        out, busy = _card_busy(run)
        return out, dict(nvml_busy=busy)
    return run(), {}


def _mesh_cycle(mesh, stepper, st):
    """One thermo cycle on the mesh from ``st``: (state, record) with the
    wall ms of the slowest rank, this rank's exchanges, bytes sent and
    launches, and what the card did (:func:`_card_use`: every rank's
    device ms with ``--mesh``, else NVML's utilization on the mesh's rank
    0)."""
    import torch.distributed as dist
    reset_kernel_launches()
    n0, b0 = mesh.exchanges, mesh.bytes_sent

    def run():
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        t0 = time.time()
        out = stepper(st)
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        return out, 1e3 * (time.time() - t0)
    (out, wall), use = _card_use(run, sample=mesh.rank == 0)
    return out, dict(wall_ms=wall, exchanges=mesh.exchanges - n0,
                     bytes_sent=mesh.bytes_sent - b0,
                     launches=kernel_launches(), **use)


def _mesh_rank(rank, world, port, model_path, tmp, queue, profile):
    """A gloo rank on cuda:0 (a process of its own): the half-degree cycle
    on each layout of MESH_LAYOUTS, BT_WIDE_HALO AUTO on the 2x2 mesh, the
    tile forms of the kernels (MESH_CHECKERS), the ensemble over ranks.
    What a mesh's rank 0 gathers goes to ``tmp``; the records go to
    ``queue``.  ``profile``: ``--mesh`` (:data:`MESH_PROFILE`).  Any failure
    fails the process."""
    global MESH_PROFILE
    import datetime
    import torch.distributed as dist
    from mom6_tpu_torch.core.barotropic import auto_wide_halo
    from mom6_tpu_torch.core.bt_widehalo import run_subcycle_widehalo
    from mom6_tpu_torch.diagnostics.sum_output import compute_stats_device
    from mom6_tpu_torch.parallel.ensemble import (
        ensemble_mesh, ensemble_step_sharded, gather_ensemble,
        shard_ensemble)
    from mom6_tpu_torch.framework.restart import RestartRegistry
    from mom6_tpu_torch.parallel.mesh import Mesh, gather, shard_model
    MESH_PROFILE = profile
    torch.set_num_threads(2)
    t_start = time.time()

    def stage(what):
        if rank == 0:
            log(f"[mesh] rank 0: {what} at {time.time() - t_start:.1f} s")
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=600))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    G, GV, st, p, f = torch.load(model_path, weights_only=False)
    dt = p.dyn.dt
    stage("the group started and the model loaded")
    rec = {"rank": rank}
    groups = {s: (None if s[0] * s[1] == world
                  else dist.new_group(list(range(s[0] * s[1]))))
              for s in MESH_LAYOUTS}
    for shape in MESH_LAYOUTS:
        if rank >= shape[0] * shape[1]:
            continue
        tag = f"{shape[0]}x{shape[1]}"
        mesh = Mesh(shape, group=groups[shape], device=dev)
        tiles = shard_model(mesh, G, GV, st, p, f)
        Gt, GVt, stt, pt, ft = tiles
        stepper = make_mom_stepper(Gt, GVt, pt, ft)
        first = shape == MESH_LAYOUTS[0]
        with mesh, torch.inference_mode():
            if first and rank in MESH_CHECKERS:
                seen, undo = _capture_tile_launches()
                solves, undo_solves = _capture_solves()
                try:
                    out, r = _mesh_cycle(mesh, stepper, stt)
                finally:
                    undo()
                    undo_solves()
            else:
                out, r = _mesh_cycle(mesh, stepper, stt)
            r["stats"] = compute_stats_device(out, Gt, GVt, dt)
            r["stats_host"] = compute_stats(out, Gt, GVt, dt)
            if first:
                # the restart written on the ranks: gathered to rank 0,
                # which writes the file one rank writes
                reg = RestartRegistry()
                reg.register_state(stt)
                torch.cuda.synchronize()
                t0 = time.time()
                reg.save_restart(os.path.join(tmp, "restart_2x2.nc"), out,
                                 time_seconds=float(p.dyn.dt
                                                    * p.n_dyn_per_thermo),
                                 step=1)
                r["restart_ms"] = 1e3 * (time.time() - t0)
            got = gather(mesh, {k: getattr(out, k) for k in MESH_FIELDS})
            if mesh.rank == 0:
                torch.save({k: v.cpu() for k, v in got.items()},
                           os.path.join(tmp, f"cycle_{tag}.pt"))
            del got
        r["tile"] = list(stt.h.shape)
        rec[tag] = r
        stage(f"the {tag} cycles done")
        del out, stepper, tiles, Gt, GVt, stt, pt, ft
        torch.cuda.empty_cache()
        if first:
            # BT_WIDE_HALO = AUTO on the same mesh
            pw = p.replace(dyn=p.dyn.replace(bt=p.dyn.bt.replace(
                wide_halo=-1)))
            Gt, GVt, stt, pt, ft = shard_model(mesh, G, GV, st, pw, f)
            stepper = make_mom_stepper(Gt, GVt, pt, ft)
            w0 = run_subcycle_widehalo.exchanges
            with mesh, torch.inference_mode():
                out, r = _mesh_cycle(mesh, stepper, stt)
                got = gather(mesh, {k: getattr(out, k)
                                    for k in MESH_FIELDS})
            r["rim_exchanges"] = run_subcycle_widehalo.exchanges - w0
            r["width"] = auto_wide_halo(pt.dyn.bt, (mesh.ny, mesh.nx),
                                        mesh.shape)
            if mesh.rank == 0:
                torch.save({k: v.cpu() for k, v in got.items()},
                           os.path.join(tmp, f"wide_{tag}.pt"))
            rec["wide " + tag] = r
            stage(f"the wide-halo {tag} cycle done")
            del out, got, stepper, Gt, GVt, stt, pt, ft
            torch.cuda.empty_cache()
            # the tile forms of the kernels, one checking rank at a time
            for checker in MESH_CHECKERS:
                dist.barrier()
                if rank == checker:
                    only = MESH_CHECKERS[checker]
                    rows = _check_tile_forms(
                        {k: v for k, v in seen.items()
                         if only is None or k[0].startswith(only)}, rank)
                    if only is None:
                        a, b, c, d = solves[0]
                        rows[("tridiag", tuple(d.shape))] = \
                            _check_tile_tridiag(a, b, c, d, rank)
                    rec["kernel_rows"] = {f"{k[0]} {list(k[1])}": v
                                          for k, v in rows.items()}
                    del seen, solves
                    torch.cuda.empty_cache()
            dist.barrier()
            stage("the tile forms checked")
    del G, GV, st, p, f
    dist.barrier()
    # the ensemble over ranks: four members, one on each rank
    Gd, GVd, std, pd, fd, ens, taux = _mesh_members(dev)
    em = ensemble_mesh(MESH_ENSEMBLE, (1, 1), device=dev)
    Gt, _, _, _, ft = shard_model(em.spatial, Gd, GVd, std, pd, fd)
    local = shard_ensemble(ens, em)
    tx = taux[em.member:em.member + 1]

    def member_step(s, t):
        return step_dynamics_split_rk2(s, ft.replace(taux=t), Gt, GVd, pd)
    with torch.inference_mode():
        out = ensemble_step_sharded(member_step, em)(local, tx)
        got = gather_ensemble(
            {k: getattr(out, k) for k in ("h", "u", "v")}, em)
    if got is not None:
        torch.save({k: v.cpu() for k, v in got.items()},
                   os.path.join(tmp, "ensemble.pt"))
    dist.barrier()
    stage("the ensemble stepped")
    for name in MESH_SMALL:
        if rank < 2:
            rec[name], rows = _mesh_small(name, rank, groups[(1, 2)], dev,
                                          tmp)
            if rows is not None:
                rec["kernel_rows " + name] = rows
        dist.barrier()
        stage(f"{name} on 1x2 done")
    queue.put(rec)
    dist.destroy_process_group()


def _mesh_small(name, rank, group, dev, tmp):
    """One cycle of configs/<name> (saved by the script's process) on the
    1x2 mesh of ranks 0-1: (its record, rank 0's tile forms checked
    against their plain versions, {row name: row}, None on rank 1).  The
    gathered h, u, v, T, S go to ``tmp``."""
    from mom6_tpu_torch.parallel.mesh import Mesh, gather, shard_model
    G, GV, st, p, f = torch.load(os.path.join(tmp, f"small_{name}.pt"),
                                 weights_only=False)
    mesh = Mesh((1, 2), group=group, device=dev)
    Gt, GVt, stt, pt, ft = shard_model(mesh, G, GV, st, p, f)
    stepper = make_mom_stepper(Gt, GVt, pt, ft)
    with mesh, torch.inference_mode():
        if rank == 0:
            seen, undo = _capture_tile_launches()
            solves, undo_solves = _capture_solves()
        try:
            out, r = _mesh_cycle(mesh, stepper, stt)
        finally:
            if rank == 0:
                undo()
                undo_solves()
        got = gather(mesh, {k: getattr(out, k) for k in MESH_FIELDS})
    r["tile"] = list(stt.h.shape)
    if rank != 0:
        return r, None
    torch.save({k: v.cpu() for k, v in got.items()},
               os.path.join(tmp, f"small_{name}_1x2.pt"))
    rows = _check_tile_forms(seen, rank)
    if solves:
        a, b, c, d = solves[0]
        rows[("tridiag", tuple(d.shape))] = _check_tile_tridiag(a, b, c, d,
                                                                rank)
    return r, {f"{k[0]} {list(k[1])}": v for k, v in rows.items()}


def _small_one_rank(name, dev, tmp):
    """configs/<name> as committed, built on the card, its CPU copy saved
    for the ranks, and one plain cycle: (the state after it, record)."""
    ms = build_model_from_params(
        ParamFile([os.path.join(REPO, "configs", name, "MOM_input")]),
        device=dev)
    G, GV, st, p, f = ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing
    torch.save((G.to("cpu"), GV.to("cpu"), st.to("cpu"), _to_cpu_params(p),
                f.to("cpu")), os.path.join(tmp, f"small_{name}.pt"))
    one = make_mom_stepper(G, GV, p, f)
    with torch.inference_mode():
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = one(st)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    return out, dict(wall_ms=wall, exchanges=0, bytes_sent=0,
                     launches=kernel_launches())


def _solve_users():
    """The modules whose tridiag_solve the cycle calls (to capture the
    first solve at a tile shape)."""
    import importlib
    return [importlib.import_module(n) for n in (
        "mom6_tpu_torch.physics.vertical.vert_friction",
        "mom6_tpu_torch.tracers.vert_diff")]


def _mesh_members(dev):
    """The ensemble's members: the double gyre at SLICE's size on ``dev``
    with winds scaled by 1 + 0.1 i, as stacked states and winds."""
    from mom6_tpu_torch.parallel.ensemble import stack_ensemble
    G, GV, st, p, f = double_gyre(
        nx=SLICE["nx"], ny=SLICE["ny"], nz=SLICE["nz"],
        len_lon_km=SLICE["len_lon_km"], len_lat_km=SLICE["len_lat_km"],
        dt=SLICE["dt"], device=dev)
    ens = stack_ensemble([st] * MESH_ENSEMBLE)
    taux = torch.stack([f.taux * (1.0 + 0.1 * i)
                        for i in range(MESH_ENSEMBLE)])
    return G, GV, st, p, f, ens, taux


def _mesh_nccl(ms, want, dt):
    """The single NCCL rank: the cycle on a 1x1 mesh of a one-rank NCCL
    group (its reductions go through NCCL) against the plain cycle."""
    import socket
    import torch.distributed as dist
    from mom6_tpu_torch.diagnostics.sum_output import compute_stats_device
    from mom6_tpu_torch.parallel.mesh import Mesh, shard_model
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = Mesh((1, 1), device=torch.device("cuda", 0))
        G, GV, st, p, f = shard_model(mesh, ms.grid, ms.vgrid, ms.state,
                                      ms.params, ms.forcing)
        stepper = make_mom_stepper(G, GV, p, f)
        with mesh, torch.inference_mode():
            out, r = _mesh_cycle(mesh, stepper, st)
            r["stats"] = compute_stats_device(out, G, GV, dt)
            for k in MESH_FIELDS:
                if not torch.equal(getattr(out, k), getattr(want, k)):
                    raise AssertionError(f"[mesh] the NCCL rank's {k} "
                                         "differs from the plain cycle")
        del out, stepper, G, GV, st, p, f
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return r


def _mesh_line(tag, r, n_ranks, dev_ms=None):
    """A cycle's line: ``r`` the mesh's rank 0's record, ``dev_ms`` the
    profiled device ms summed over the ranks (``--mesh``)."""
    if dev_ms is not None:
        use = (f"{dev_ms:.1f} device ms over the ranks, the card idle "
               f"{100.0 * (1.0 - dev_ms / r['wall_ms']):.1f}% of this "
               f"profiled cycle (torch.profiler)")
    elif r.get("nvml_busy") is not None:
        use = (f"NVML's utilization.gpu {r['nvml_busy']:.1f}% (sampled "
               f"every 100 ms; not an idle share)")
    else:
        use = "the card's use not measured"
    log(f"[mesh] {tag}: {n_ranks} rank(s), {r['wall_ms']:.1f} wall ms a "
        f"cycle; {r['exchanges']} exchanges and {r['bytes_sent']} bytes "
        f"sent a cycle a rank (rank 0); launches a rank (rank 0) "
        f"{ {k: v for k, v in r['launches'].items() if v} }; {use}")


def phase_mesh(dev, card):
    """[mesh]: the half-degree global model (720x400x32, f32) with the
    harmonic SAL, SPPT and SKEB (MESH_OVERRIDE) for one thermo cycle on
    2x2 and 1x2 gloo ranks that share cuda:0, with BT_WIDE_HALO AUTO on
    the 2x2 mesh, and on one NCCL rank: each gathered h, u, v, T, S and
    its ocean.stats to the bit with the plain one-rank cycle; the 2x2
    cycle's restart written on the ranks and restored on one rank, every
    field to the bit; dome and isomip (MESH_SMALL) for one cycle on 1x2
    ranks against one rank; the kernels' tile forms at the tiles' shapes
    against their plain versions (0 ulps); the ensemble of four members,
    one a rank, to the bit with one process.  Returns (the 2x2 rank 0's
    launch counts, {row name: [kernel rows]})."""
    import multiprocessing as mp
    import socket
    import tempfile
    from mom6_tpu_torch.diagnostics.sum_output import compute_stats_device
    from mom6_tpu_torch.framework.restart import RestartRegistry
    from mom6_tpu_torch.parallel.ensemble import ensemble_step
    t0 = time.time()
    ms = build_model_from_params(
        ParamFile([os.path.join(GLOBAL_DIR, "MOM_input")],
                  text=MESH_OVERRIDE), device=dev)
    G, GV, st, p, f = ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing
    if p.sal_harmonics is None or p.sppt is None or not p.skeb_scale > 0.0:
        raise AssertionError("[mesh] the options did not reach the model")
    log(f"[mesh] built global_half_deg with {MESH_OVERRIDE.split()[::3]} in "
        f"{time.time() - t0:.1f} s (SAL degree {p.sal_harmonics.nmax})")
    dt = p.dyn.dt
    one = make_mom_stepper(G, GV, p, f)
    with torch.inference_mode():
        reset_kernel_launches()

        def run():
            torch.cuda.synchronize()
            t0 = time.time()
            out = one(st)
            torch.cuda.synchronize()
            return out, 1e3 * (time.time() - t0)
        (want, plain_ms), use = _card_use(run)
    stats_want = compute_stats_device(want, G, GV, dt)
    host_want = compute_stats(want, G, GV, dt)
    _mesh_line("the plain one-rank cycle (no process group)",
               dict(wall_ms=plain_ms, exchanges=0, bytes_sent=0,
                    launches=kernel_launches(), **use), 1,
               use.get("device_ms"))
    os.makedirs(OUT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=OUT)
    try:
        small = {name: _small_one_rank(name, dev, tmp) for name in MESH_SMALL}
        for name, (_, r) in small.items():
            _mesh_line(f"{name}, the plain one-rank cycle", r, 1)
        model_path = os.path.join(tmp, "model.pt")
        torch.save((G.to("cpu"), GV.to("cpu"), st.to("cpu"),
                    _to_cpu_params(p), f.to("cpu")), model_path)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=_mesh_rank,
                             args=(r, MESH_RANKS, port, model_path, tmp,
                                   queue, MESH_PROFILE))
                 for r in range(MESH_RANKS)]
        t_spawn = time.time()
        for pr in procs:
            pr.start()
        recs = {}
        try:
            while len(recs) < MESH_RANKS:
                try:
                    r = queue.get(timeout=5)
                    recs[r["rank"]] = r
                except Exception:
                    dead = [pr for pr in procs
                            if not pr.is_alive() and pr.exitcode != 0]
                    if dead:
                        raise AssertionError(
                            f"[mesh] a rank failed: exit codes "
                            f"{[pr.exitcode for pr in procs]}")
                    if time.time() - t_spawn > 900:
                        raise AssertionError("[mesh] the ranks timed out")
            for pr in procs:
                pr.join(timeout=120)
                if pr.exitcode != 0:
                    raise AssertionError(f"[mesh] a rank exited with "
                                         f"{pr.exitcode}")
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        log(f"[mesh] {MESH_RANKS} gloo ranks on cuda:0: "
            f"{time.time() - t_spawn:.1f} s from their start to their end")
        # each gathered cycle to the bit with the plain cycle
        for tag in [f"{a}x{b}" for a, b in MESH_LAYOUTS] + [
                f"wide {MESH_LAYOUTS[0][0]}x{MESH_LAYOUTS[0][1]}"]:
            path = os.path.join(tmp, ("cycle_" + tag if " " not in tag
                                      else tag.replace(" ", "_")) + ".pt")
            got = torch.load(path)
            for k in MESH_FIELDS:
                w = getattr(want, k).cpu()
                if not torch.equal(got[k], w):
                    raise AssertionError(
                        f"[mesh] {tag}: {k} differs from the one-rank "
                        f"cycle by {rel_err(got[k], w):.3e}")
            log(f"[mesh] {tag}: h, u, v, T, S gathered equal the plain "
                f"one-rank cycle to the bit")
        for shape in MESH_LAYOUTS:
            tag = f"{shape[0]}x{shape[1]}"
            r0 = recs[0][tag]
            for r in range(shape[0] * shape[1]):
                s = recs[r][tag]
                if s["stats"] != stats_want or s["stats_host"] != host_want:
                    raise AssertionError(f"[mesh] {tag} rank {r}: ocean."
                                         f"stats {s['stats']} differs from "
                                         f"{stats_want}")
            n = shape[0] * shape[1]
            _mesh_line(f"{tag} gloo, tile {r0['tile']}", r0, n,
                       sum(recs[r][tag]["device_ms"] for r in range(n))
                       if MESH_PROFILE else None)
        log(f"[mesh] ocean.stats on every mesh equal the plain cycle's to "
            f"the bit, device {stats_want} and host {host_want}")
        tagw = f"{MESH_LAYOUTS[0][0]}x{MESH_LAYOUTS[0][1]}"
        # the restart written on 2x2, restored on one rank
        path = os.path.join(tmp, "restart_2x2.nc")
        reg = RestartRegistry()
        reg.register_state(st)
        torch.cuda.synchronize()
        t0 = time.time()
        back = reg.restore_state(path, st)[0]
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.time() - t0)
        for n in reg.names:
            if not torch.equal(reg.get(n, back), reg.get(n, want)):
                raise AssertionError(f"[mesh] the restart's {n} written on "
                                     "2x2 and restored on one rank differs "
                                     "from the one-rank cycle's")
        log(f"[mesh] restart across layouts: written on 2x2 (gathered to "
            f"rank 0, {recs[0][tagw]['restart_ms']:.1f} wall ms, no halo "
            f"exchange, {os.path.getsize(path)} bytes), restored on one rank "
            f"({restore_ms:.1f} wall ms): its {len(reg.names)} fields "
            f"{reg.names} equal the one-rank cycle's to the bit")
        del back
        for name in MESH_SMALL:
            want_s = small[name][0]
            got = torch.load(os.path.join(tmp, f"small_{name}_1x2.pt"))
            for k in MESH_FIELDS:
                if not torch.equal(got[k], getattr(want_s, k).cpu()):
                    raise AssertionError(
                        f"[mesh] {name} 1x2: {k} differs from the one-rank "
                        f"cycle by {rel_err(got[k], getattr(want_s, k).cpu()):.3e}")
            _mesh_line(f"{name} 1x2 gloo, tile {recs[0][name]['tile']}, h, u, "
                       f"v, T, S gathered equal the one-rank cycle to the bit",
                       recs[0][name], 2)
        wide, dense = recs[0]["wide " + tagw], recs[0][tagw]
        log(f"[mesh] BT_WIDE_HALO AUTO on {tagw}: width {wide['width']}, "
            f"{wide['exchanges']} exchanges a cycle ({wide['rim_exchanges']}"
            f" rim exchanges) against the dense path's {dense['exchanges']};"
            f" {wide['wall_ms']:.1f} wall ms against {dense['wall_ms']:.1f}")
        if not (wide["width"] > 0 and wide["exchanges"] < dense["exchanges"]):
            raise AssertionError("[mesh] the wide halo took no fewer "
                                 "exchanges")
        # the ensemble over ranks against one process
        Gd, GVd, std, pd, fd, ens, taux = _mesh_members(dev)

        def member_step(s, t):
            return step_dynamics_split_rk2(s, fd.replace(taux=t), Gd, GVd,
                                           pd)
        with torch.inference_mode():
            one_ens = ensemble_step(member_step)(ens, taux)
        got = torch.load(os.path.join(tmp, "ensemble.pt"))
        for k in ("h", "u", "v"):
            if not torch.equal(got[k], getattr(one_ens, k).cpu()):
                raise AssertionError(f"[mesh] the ensemble's {k} over ranks "
                                     f"differs from one process")
        log(f"[mesh] the ensemble of {MESH_ENSEMBLE} double-gyre members "
            f"({SLICE['nx']}x{SLICE['ny']}x{SLICE['nz']}), one a rank, "
            f"equals ensemble_step in one process to the bit")
        del one_ens, ens, Gd, GVd, std, pd, fd
        nccl = _mesh_nccl(ms, want, dt)
        if nccl["stats"] != stats_want:
            raise AssertionError("[mesh] the NCCL rank's ocean.stats differ")
        _mesh_line("1x1 NCCL rank, equal to the plain cycle to the bit",
                   nccl, 1, nccl.get("device_ms"))
        rows = {}
        for r in MESH_CHECKERS:
            for key, row in recs[r]["kernel_rows"].items():
                name = key.split(" ")[0]
                row = dict(row, rank=r, path="mesh 2x2")
                rows.setdefault(name, []).append(row)
        for small_name in MESH_SMALL:
            for key, row in recs[0]["kernel_rows " + small_name].items():
                rows.setdefault(key.split(" ")[0], []).append(
                    dict(row, rank=0, path=f"mesh 1x2 {small_name}"))
        return recs[0][tagw]["launches"], rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _to_cpu_params(p):
    """The model parameters with their tensors on the host (to hand them
    to the ranks)."""
    from mom6_tpu_torch.framework.containers import tree_map
    return tree_map(lambda t: t.to("cpu"), p)



def gate_main(names):
    """``--gate NAME[,NAME...]``: physics gates on the card (those of
    HOST_GATES with CPU tensors), one after the other in this process,
    each its record and its launch counts as one JSON line; a miss exits
    non-zero after the last."""
    import torch_gates
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    failed = []
    for name in names.split(","):
        reset_kernel_launches()
        host = name in HOST_GATES
        if host:
            torch.set_num_threads(1)
        try:
            rec = torch_gates.run_gate(name, "cpu" if host else "cuda")
            rec["device"] = "cpu" if host else "cuda"
        except AssertionError as e:
            print("GATE " + json.dumps({"name": name, "passed": False,
                                        "error_text": repr(e)[:2000]}),
                  flush=True)
            failed.append(name)
            continue
        print("GATE " + json.dumps({"name": name, "passed": True,
                                    "record": rec,
                                    "counts": kernel_launches()}),
              flush=True)
    if failed:
        raise AssertionError(f"gates failed: {failed}")


def main():
    if "--gate" in sys.argv:
        gate_main(sys.argv[sys.argv.index("--gate") + 1])
        return
    t_start = time.time()
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    ms = build_global(dev)
    if "--table" in sys.argv:
        for shape in WAVE_TRIDIAG:
            _check_tridiag_wave(shape, dev)
        t0 = time.time()
        phase_solo_table(dev, ms)
        log(f"[time] solo table: {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_solo_table_cpu(start_table_cpu())
        log(f"[time] solo table, the CPU's run: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    if "--options" in sys.argv:
        for shape in SPLIT_TRIDIAG:
            _check_tridiag_split(dev, shape)
        t0 = time.time()
        phase_options(dev, card)
        torch.cuda.empty_cache()
        _options_small(dev)
        log(f"[time] options: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    if "--lateral" in sys.argv:
        _check_porous_fluxes(ms, dev)
        del ms
        torch.cuda.empty_cache()
        t0 = time.time()
        phase_lateral(dev, card)
        torch.cuda.empty_cache()
        _lateral_small(dev)
        log(f"[time] lateral: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    if "--stoch" in sys.argv:
        del ms
        torch.cuda.empty_cache()
        t0 = time.time()
        phase_rng(dev, card)
        phase_eos(dev, card)
        phase_stoch(dev, card)
        torch.cuda.empty_cache()
        phase_tides(dev)
        log(f"[time] stoch: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    if "--hybgen" in sys.argv:
        t0 = time.time()
        phase_hybgen(dev, ms, card)
        del ms
        torch.cuda.empty_cache()
        phase_ice_solo(dev, card)
        log(f"[time] hybgen and ice_solo: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    if "--rk2b-oda" in sys.argv:
        t0 = time.time()
        phase_rk2b(dev, card)
        torch.cuda.empty_cache()
        phase_oda(dev, ms, card)
        _small_rk2b_card_vs_cpu(dev, card)
        _oda_small_card_vs_cpu(dev, card)
        log(f"[time] rk2b and oda: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    if "--mesh" in sys.argv:
        del ms
        torch.cuda.empty_cache()
        t0 = time.time()
        counts, rows = phase_mesh(dev, card)
        log(f"[time] mesh: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        log(json.dumps({"mesh_launches": counts, "mesh_rows": rows}))
        return
    if "--coupled" in sys.argv:
        _check_tridiag_shared(dev, COUPLED_SHARED)
        _check_remap(COUPLED_REMAP, dev, {})
        t0 = time.time()
        phase_coupled(dev)
        log(f"[time] coupled: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    results = phase_kernels(dev, ms)
    if "--kernels" in sys.argv:
        log(f"[card] {card}")
        log(json.dumps({"tree": TREE, "kernel_ms": TIMES}))
        return
    seconds = {"device, build and kernels": time.time() - t_start}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t0
        log(f"[time] {name}: {seconds[name]:.1f} s")
        return out

    timed("fold", phase_fold_exact, dev)
    counts = {"double_gyre": timed("double_gyre", phase_slice, dev)}
    counts.update(timed("full_physics", phase_full_physics, dev))
    counts["global_half_deg"] = timed("global_half_deg", phase_global, dev,
                                      ms)
    counts["solo_global_half_deg"] = timed("solo global_half_deg",
                                           phase_solo_global, dev, ms)
    counts.update(timed("solo table", phase_solo_table, dev, ms))
    counts.update(timed("obc", phase_obc, dev))
    counts.update(timed("rundirs", phase_rundirs, dev))
    timed("ops", phase_ops, dev, ms)
    counts["coupled"] = timed("coupled", phase_coupled, dev)
    counts["options"] = timed("options", phase_options, dev, card)
    counts["lateral"] = timed("lateral", phase_lateral, dev, card)
    timed("rng", phase_rng, dev, card)
    timed("eos", phase_eos, dev, card)
    counts["stoch"] = timed("stoch", phase_stoch, dev, card)
    counts["hybgen"] = timed("hybgen", phase_hybgen, dev, ms, card)
    timed("ice_solo", phase_ice_solo, dev, card)
    counts["rk2b"] = timed("rk2b", phase_rk2b, dev, card)
    torch.cuda.empty_cache()
    counts["oda"] = timed("oda", phase_oda, dev, ms, card)
    del ms
    torch.cuda.empty_cache()
    counts["mesh"], mesh_rows = timed("mesh", phase_mesh, dev, card)
    for name, rs in mesh_rows.items():
        SHAPE_ROWS.setdefault(name, []).extend(rs)
    results["ppm_edges_y_halo"] = next(
        r for r in mesh_rows["ppm_edges_y_halo"] if r["rank"] == 0
        and r["path"] == "mesh 2x2")
    torch.cuda.empty_cache()
    # the gates' processes run beside the checks that follow (nothing after
    # this point is timed for a report but the gates themselves)
    pool = start_gates()
    table_cpu = start_table_cpu()
    try:
        timed("f64", phase_f64, dev)
        timed("options, card against CPU", _options_small, dev)
        timed("lateral, card against CPU", _lateral_small, dev)
        timed("tides, card against CPU", phase_tides, dev)
        timed("rk2b, card against CPU", _small_rk2b_card_vs_cpu, dev, card)
        timed("oda, card against CPU", _oda_small_card_vs_cpu, dev, card)
        timed("golden", phase_golden, dev)
        counts["tracer_batch"] = timed("tracer_batch", phase_tracer_batch,
                                       dev)
        timed("solo runs", phase_solo_runs, dev)
        counts["physics"] = timed("physics (the rest of the gates' time)",
                                  phase_physics, pool)
        timed("solo table, the CPU's run (the rest of its time)",
              phase_solo_table_cpu, table_cpu)
    finally:
        stop_gates(pool)
        if table_cpu[1][0].poll() is None:
            table_cpu[1][0].kill()
            table_cpu[1][0].communicate()
    seconds["all"] = time.time() - t_start
    log("[time] " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    rows = []
    for name in kernel_launches():
        src, rep = META[name]
        # launches: on this slice's path, global_half_deg (the wrap rows of
        # the y passes: on thermo_gyre, the last path that launches them;
        # the quartic remap: on hycom_basin); every path's count, each read
        # after its own reset, beside it; and the kernel's row at every
        # shape checked
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=counts[ROW_PATH.get(
                             name, "global_half_deg")][name],
                         launches_by_path={p: c.get(name, 0)
                                           for p, c in counts.items()},
                         **results[name], shapes=SHAPE_ROWS.get(name, [])))
    log(f"[card] {card}")
    log(json.dumps({"kernels": rows}))
    if any(not math.isfinite(r["ms"]) for r in rows):
        raise AssertionError("kernel time not measured")
    if any(r["launches"] <= 0 for r in rows):
        raise AssertionError("a kernel was launched no time on its path")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
