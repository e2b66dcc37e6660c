"""Resilience planes of the port: the fault points' hooks
(:mod:`.faults`), the divergence and drift guard (:mod:`.divergence`) and
the per-phase deadline watchdog (:mod:`.watchdog`)."""
