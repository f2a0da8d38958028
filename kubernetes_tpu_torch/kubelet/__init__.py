"""The node agent's pieces the port needs so far.

Only securitycontext.py is here: the admission plugins read
`effective_privileged` from it. The kubelet's sync machinery (the JAX
package's kubelet/ runtime, PLEG, probers and server) is not ported
(ROADMAP.md Queue 1)."""
