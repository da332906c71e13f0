"""Fixture root: exempted-lazy-backend import-purity mini-tree."""
