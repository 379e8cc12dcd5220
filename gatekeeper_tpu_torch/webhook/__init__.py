"""Admission: the validation handler (:mod:`.policy`), its HTTP server
(:mod:`.server`), the brownout ladder (:mod:`.overload`), the
micro-batcher that coalesces concurrent reviews into one engine pass
(:mod:`.batcher`) and the in-cluster registration (:mod:`.bootstrap`)."""
