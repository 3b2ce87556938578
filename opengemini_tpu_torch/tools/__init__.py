"""Operator tools: backup/restore (reference: app/ts-recover, lib/backup).

The port of ``opengemini_tpu/tools/__init__.py``, whole, with its
imports rewritten.
"""
