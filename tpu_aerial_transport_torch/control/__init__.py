"""Controllers: the centralized RQP SOCP + CBF filter, C-ADMM and
dual-decomposition distributed solvers, the RP centralized and C-ADMM
controllers, the PMRL centralized controller, low-level SO(3) control and
shared types (``cadmm``, ``centralized``, ``dd``, ``lowlevel``,
``pmrl_centralized``, ``rp_cadmm``, ``rp_centralized``, ``so3_tracking``,
``types``)."""
