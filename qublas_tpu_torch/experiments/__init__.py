"""Measurement scripts run on the card to choose kernel designs; the
package does not import them."""
