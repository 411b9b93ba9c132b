"""Launching the port over several ranks: the sampling mesh (``mesh``) and
the distributed solve with its ``queue_sharded`` engine (``im_solve``)."""
