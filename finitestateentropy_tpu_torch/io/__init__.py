"""Host-side file jobs: resumable TurboRANS compression (jobs.py).

The JAX package's io/ also holds the compat frame layer (frame.py); the
port's copy of it comes with the compat codecs.
"""
