"""Workflow graphs: the executor that runs a node graph (``executor``) and
its command-line runner (``run_workflow``)."""
