"""Placement rules for the production (mesh) tier: ``sharding``."""
