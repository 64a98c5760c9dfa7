"""The mesh's collectives (``annotate``): the port's counterpart of the JAX
package's layout pins. The LM parameter rules of ``sharding/rules.py`` wait
for the LM stack."""
