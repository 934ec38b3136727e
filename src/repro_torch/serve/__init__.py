"""Serving package of the port.  ``playbook`` holds the ladder rules of the
``slo`` channel; the serving engine and workload are not ported yet
(ROADMAP Queue 1 item 4)."""
