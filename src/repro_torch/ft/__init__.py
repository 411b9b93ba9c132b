"""Fault tolerance on the port: the fault policy and its injector
(``failures``), round timers (``straggler``) and the restart loop
(``runner``)."""
