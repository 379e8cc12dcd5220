"""Admission: the micro-batcher that coalesces concurrent reviews into
one engine pass (:mod:`.batcher`).  The JAX package's validation
handler, HTTPS server, overload controller and bootstrap are not part
of the port yet."""
