"""Manifold geometry: SO(3), S², rigid transforms and the filter state."""
