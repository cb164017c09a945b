"""Neural-network pieces (port of ``znicz_tpu/nn``): so far the host-side
decision state; the unit zoo is ROADMAP.md queue 1 item 4."""
