"""Multi-swarm runs; so far the island model on one device."""
